"""Processing-step chain of the library preparation: each step validates
its input, then transforms it."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class ProcessingStep:
    def __call__(self, input_):
        if not self.validate(input_):
            raise ValueError(f"{self.__class__.__name__}: invalid input {type(input_).__name__}")
        logger.info("Running library step %s", self.__class__.__name__)
        return self.forward(input_)

    def validate(self, input_) -> bool:
        return True

    def forward(self, input_):
        raise NotImplementedError


class ProcessingPipeline:
    def __init__(self, steps: list[ProcessingStep]):
        self.steps = steps

    def __call__(self, input_):
        for step in self.steps:
            input_ = step(input_)
        return input_
