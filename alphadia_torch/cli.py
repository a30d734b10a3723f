"""Command-line interface: ``alphadia-torch``.

The JAX package's flags and aliases (``--config`` YAML, repeated
``--config-dict`` JSON, raw files from ``-f`` / ``-d`` (with ``-r``), a
``.d`` directory counting as a raw file, ``--library``, ``--fasta``,
``--quant-dir``, ``-o``), then a ``SearchPlan`` on the card. The YAML is
read by ``config/yaml_subset.load`` (no yaml package on the card machine).
``ALPHADIA_TORCH_DEVICE`` (``cpu`` / ``cuda``) picks the device; without it
the search runs on this process's cards and stops where there is none.
Under ``torchrun`` (or the JAX package's ``ALPHADIA_TPU_COORDINATOR`` /
``_NUM_PROCESSES`` / ``_PROCESS_ID``) every process runs this command with
the same flags: each searches its share of the raw files into the shared
``--quant-dir`` on its own cards, and process 0 writes the cross-run
outputs (``parallel/distributed``).
``--profile-dir DIR`` sets ``general.profile_directory``: a profiler trace
of each raw file in ``DIR/<raw name>/trace.json``.

Exit codes: 127 a user error, 126 a business error, 1 anything else; each
process of a group exits with its own.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
from pathlib import Path

from alphadia_torch import __version__
from alphadia_torch.config import yaml_subset
from alphadia_torch.exceptions import BusinessError, UserError
from alphadia_torch.reporting import init_logging
from alphadia_torch.utils.device import resolve_device

logger = logging.getLogger("alphadia_torch")

DEVICE_ENV = "ALPHADIA_TORCH_DEVICE"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("alphadia-torch", description="DIA search engine on an NVIDIA card (PyTorch and CUDA)")
    p.add_argument("-v", "--version", action="store_true", help="print version and exit")
    p.add_argument("--check", action="store_true", help="print version string for GUI discovery")
    p.add_argument("-o", "--output", "--output-directory", dest="output", help="output directory")
    p.add_argument("-f", "--file", "--raw-path", dest="file", action="append", default=[], help="raw file path (repeatable)")
    p.add_argument("-d", "--directory", action="append", default=[], help="directory of raw files (repeatable)")
    p.add_argument("-r", "--regex", default=".*", help="regex filter for files from --directory")
    p.add_argument("-l", "--library", "--library-path", dest="library", help="spectral library path")
    p.add_argument("--fasta", "--fasta-path", dest="fasta", action="append", default=[], help="FASTA path (repeatable)")
    p.add_argument("-c", "--config", help="YAML config file")
    p.add_argument("--config-dict", action="append", default=[], help="JSON config override (repeatable)")
    p.add_argument("--quant-dir", "--quant-directory", dest="quant_dir", help="shared quant directory")
    p.add_argument("--profile-dir", help="write a profiler trace per raw file into this directory")
    return p


def _get_config_from_args(args) -> dict:
    if not args.config:
        return {}
    with open(args.config) as f:
        return yaml_subset.load(f.read()) or {}


def _deep_merge(base: dict, patch: dict) -> None:
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v


def _get_raw_path_list_from_args_and_config(args, config: dict) -> list[str]:
    paths = list(config.get("raw_paths", []) or [])
    paths += list(args.file)
    pattern = re.compile(args.regex)
    for directory in args.directory:
        for p in sorted(Path(directory).iterdir()):
            # Bruker .d raw "files" are directories
            is_raw = p.is_file() or (p.is_dir() and p.suffix.lower() == ".d")
            if is_raw and pattern.search(p.name):
                paths.append(str(p))
    return paths


def _get_cli_config(args, config: dict) -> dict:
    cli: dict = {}
    for text in args.config_dict:
        _deep_merge(cli, json.loads(text))
    raw_paths = _get_raw_path_list_from_args_and_config(args, config)
    if raw_paths:
        cli["raw_paths"] = raw_paths
    if args.library:
        cli["library_path"] = args.library
    if args.fasta:
        cli["fasta_paths"] = list(args.fasta)
    if args.quant_dir:
        cli["quant_directory"] = args.quant_dir
    if args.profile_dir:
        _deep_merge(cli, {"general": {"profile_directory": args.profile_dir}})
    return cli


def _device():
    """``"cpu"``, or None for this process's cards (checked to exist)."""
    name = os.environ.get(DEVICE_ENV)
    if name not in (None, "", "cpu", "cuda"):
        raise UserError(f"{DEVICE_ENV}={name!r}: the device is 'cpu' or 'cuda'")
    try:
        resolve_device(name or None)
    except RuntimeError as e:
        raise UserError(f"{e} (set {DEVICE_ENV}=cpu)") from e
    return "cpu" if name == "cpu" else None


def run(argv: list[str] | None = None) -> None:
    args = _build_parser().parse_args(argv)
    if args.version or args.check:
        print(f"alphadia-torch {__version__}")
        return
    if not logger.handlers:
        init_logging()

    from alphadia_torch.search_plan import SearchPlan

    try:
        # argument and config assembly failures are user errors
        try:
            config = _get_config_from_args(args)
            cli_config = _get_cli_config(args, config)
        except (OSError, ValueError, KeyError, re.error) as e:
            raise UserError(f"invalid arguments/config: {e}") from e
        output = args.output or config.get("output_directory")
        if not output:
            raise UserError("-o/--output is required (or output_directory in --config)")
        SearchPlan(output, config=config, cli_config=cli_config, device=_device()).run_plan()
    except UserError as e:
        logger.error(f"user error: {e}")
        sys.exit(127)
    except BusinessError as e:
        logger.error(f"business error: {e}")
        sys.exit(126)
    except Exception as e:
        logger.error(f"unknown error: {e}", exc_info=True)
        sys.exit(1)


if __name__ == "__main__":
    run()
