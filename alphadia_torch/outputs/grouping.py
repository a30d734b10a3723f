"""Protein inference: greedy set cover with parsimony groups, and the
heuristic filter.

Per decoy class (ascending), the protein that covers the most precursors
becomes a master and its precursors leave every other protein; with
``return_parsimony_groups`` a protein left with none joins the master's
group. The heuristic (``group``) then keeps in each precursor's group only
proteins that are master somewhere, sorted.

Ties of the cover go to the protein seen first: the protein dict is built
over the precursors in the order of their first row (pandas'
``drop_duplicates("precursor_idx")``), so a table of several runs must come
in the runs' order, as the JAX package concatenates them.
"""

from __future__ import annotations

import numpy as np


def _group_and_parsimony(precursor_idx, precursor_ids, return_parsimony_groups=False):
    id_dict: dict[str, set] = {}
    for prec, ids in zip(precursor_idx, precursor_ids):
        for pid in str(ids).split(";"):
            id_dict.setdefault(pid, set()).add(prec)

    id_group, id_master, precursor_set = [], [], []
    for _ in range(len(id_dict)):
        query_id = max(id_dict, key=lambda k: len(id_dict[k]))
        query_peptides = id_dict.pop(query_id)
        if not query_peptides:
            break
        query_group = [query_id]
        for subject, peptides in id_dict.items():
            if not peptides:
                continue
            remaining = peptides - query_peptides
            id_dict[subject] = remaining
            if return_parsimony_groups and not remaining:
                query_group.append(subject)
        id_group.append(";".join(query_group))
        id_master.append(query_id)
        precursor_set.append(query_peptides)

    mapping = {}
    for master, group, peptides in zip(id_master, id_group, precursor_set):
        for p in peptides:
            mapping[p] = (master, group)

    if len(mapping) != len(set(precursor_idx)):
        raise ValueError("grouping lost precursors")

    masters = [mapping[p][0] for p in precursor_idx]
    groups = [mapping[p][1] for p in precursor_idx]
    return masters, groups


def _as_str(values) -> np.ndarray:
    """pandas' ``astype(str)`` of a column (None and NaN become text too)."""
    return np.array([str(v) for v in values], dtype=object)


def perform_grouping(
    psm_df: dict,
    genes_or_proteins: str = "proteins",
    decoy_column: str = "decoy",
    group: bool = True,
    return_parsimony_groups: bool = False,
) -> dict:
    """``psm_df`` with ``pg_master`` and ``pg`` per row."""
    if genes_or_proteins not in ("genes", "proteins"):
        raise ValueError("genes_or_proteins must be 'genes' or 'proteins'")
    psm_df = dict(psm_df)
    psm_df[genes_or_proteins] = _as_str(psm_df[genes_or_proteins])

    prec = np.asarray(psm_df["precursor_idx"])
    _, first = np.unique(prec, return_index=True)
    first = np.sort(first)
    u_prec = prec[first]
    u_ids = psm_df[genes_or_proteins][first]
    u_decoy = np.asarray(psm_df[decoy_column])[first]

    master_of: dict = {}
    pg_of: dict = {}
    ids_of: dict = {}
    for d in np.unique(u_decoy):
        sel = u_decoy == d
        masters, groups = _group_and_parsimony(u_prec[sel], u_ids[sel], return_parsimony_groups)
        for p, m, g, ids in zip(u_prec[sel].tolist(), masters, groups, u_ids[sel]):
            master_of[p], pg_of[p], ids_of[p] = m, g, ids

    if group:
        allowed = {g.split(";")[0] for g in pg_of.values()}
        for p, ids in ids_of.items():
            pg_of[p] = ";".join(sorted(set(str(ids).split(";")) & allowed))

    rows = prec.tolist()
    psm_df["pg_master"] = np.array([master_of[p] for p in rows], dtype=object)
    psm_df["pg"] = np.array([pg_of[p] for p in rows], dtype=object)
    return psm_df
