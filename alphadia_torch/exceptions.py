"""Exception hierarchy: a ``CustomError`` base with an error code and a
message, split into business errors (data-dependent: the search continues
with the next raw file unless ``fail_fast``) and user errors
(configuration problems: abort at once)."""

from __future__ import annotations


class CustomError(Exception):
    """Base class for all custom errors with an error code."""

    _error_code: str = "CUSTOM_ERROR"
    _msg: str = "Unspecified error"
    _detail_msg: str = ""

    def __init__(self, msg: str | None = None, detail_msg: str | None = None):
        if msg is not None:
            self._msg = msg
        if detail_msg is not None:
            self._detail_msg = detail_msg
        super().__init__(self._msg)

    @property
    def error_code(self) -> str:
        return self._error_code

    @property
    def msg(self) -> str:
        return self._msg

    @property
    def detail_msg(self) -> str:
        return self._detail_msg


class BusinessError(CustomError):
    """Data-dependent error: this raw file failed, others may succeed."""

    _error_code = "BUSINESS_ERROR"


class UserError(CustomError):
    """User-caused error: configuration / input problem, abort."""

    _error_code = "USER_ERROR"


class NoPsmFoundError(BusinessError):
    _error_code = "NO_PSM_FOUND"
    _msg = "No PSMs found in the search results."


class NoRecalibrationTargetError(BusinessError):
    _error_code = "NO_RECALIBRATION_TARGET"
    _msg = (
        "Searched all data without finding enough precursors for calibration. "
        "Check search settings and library/raw-file match."
    )


class NotDiaDataError(BusinessError):
    _error_code = "NOT_DIA_DATA"
    _msg = "The raw file is not a valid DIA acquisition."


class TooFewPsmError(BusinessError):
    _error_code = "TOO_FEW_PSM"
    _msg = "Too few PSMs for downstream statistics."


class TooFewProteinsError(BusinessError):
    _error_code = "TOO_FEW_PROTEINS"
    _msg = "Too few proteins for protein-level FDR."


class NoLibraryAvailableError(UserError):
    _error_code = "NO_LIBRARY_AVAILABLE"
    _msg = "No spectral library available: provide a library or FASTA with prediction enabled."


class ConfigError(UserError):
    _error_code = "CONFIG_ERROR"
    _msg = "Invalid configuration."


class KeyAddedConfigError(ConfigError):
    _error_code = "CONFIG_KEY_ADDED"

    def __init__(self, key: str, source: str):
        super().__init__(
            f"Config update would add unknown key '{key}' (from '{source}'). "
            "Only keys present in the default config may be set."
        )
        self.key = key
        self.source = source


class TypeMismatchConfigError(ConfigError):
    _error_code = "CONFIG_TYPE_MISMATCH"

    def __init__(self, key: str, expected: type, got: object, source: str):
        super().__init__(
            f"Config key '{key}' expects type {expected.__name__}, got "
            f"{type(got).__name__} ({got!r}) from '{source}'."
        )
        self.key = key


class GenericUserError(UserError):
    _error_code = "GENERIC_USER_ERROR"


class NotPortedError(UserError):
    """A setting or input whose code comes with a later slice of the port."""

    _error_code = "NOT_PORTED"
