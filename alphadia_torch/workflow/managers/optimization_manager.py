"""Mutable search-parameter state: the ms1, ms2, RT and mobility
tolerances, the candidate count, the RT and mobility FWHM, the score cutoff,
the classifier version and the quadrupole model, initialised from the
config (an RT tolerance in (0, 1] is a fraction of the gradient)."""

from __future__ import annotations

from alphadia_torch.workflow.managers.base import BaseManager


class OptimizationManager(BaseManager):
    def __init__(self, config, gradient_length: float, path=None, load_from_file=False):
        super().__init__(path, load_from_file)
        if self.is_loaded_from_file:
            return
        rt_tol = config["search_initial"]["rt_tolerance"]
        self.rt_error = rt_tol * gradient_length if 0 < rt_tol <= 1 else rt_tol
        self.ms1_error = config["search_initial"]["ms1_tolerance"]
        self.ms2_error = config["search_initial"]["ms2_tolerance"]
        self.mobility_error = config["search_initial"]["mobility_tolerance"]
        self.num_candidates = config["search_initial"]["num_candidates"]
        self.fwhm_rt = config["optimization_manager"]["fwhm_rt"]
        self.fwhm_mobility = config["optimization_manager"]["fwhm_mobility"]
        self.score_cutoff = config["optimization_manager"]["score_cutoff"]
        self.classifier_version = -1
        # the run's quadrupole transmission model (search/quadrupole.py),
        # unfitted: a plateau with soft edges
        self.quad_sigma = (0.2, 0.2)
        self.quad_delta_mu = (0.0, 0.0)

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown optimization parameter {k}")
            setattr(self, k, v)
