from alphadia_torch.reporting.reporting import PROGRESS, default_pipeline, init_logging, logger

__all__ = ["PROGRESS", "default_pipeline", "init_logging", "logger"]
