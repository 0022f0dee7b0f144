"""Error-code discipline mirroring speex_resampler.h:104-113 and
speex_resampler_strerror (resample.c:1222-1239)."""

from __future__ import annotations

import enum

__all__ = ["ResamplerError", "ResamplerErrorCode", "strerror",
           "QUALITY_MAX", "QUALITY_MIN", "QUALITY_DEFAULT", "QUALITY_VOIP",
           "QUALITY_DESKTOP"]

# speex_resampler.h:98-102
QUALITY_MAX = 10
QUALITY_MIN = 0
QUALITY_DEFAULT = 4
QUALITY_VOIP = 3
QUALITY_DESKTOP = 5


class ResamplerErrorCode(enum.IntEnum):
    SUCCESS = 0
    ALLOC_FAILED = 1
    BAD_STATE = 2
    INVALID_ARG = 3
    PTR_OVERLAP = 4
    OVERFLOW = 5


_MESSAGES = {
    ResamplerErrorCode.SUCCESS: "Success.",
    ResamplerErrorCode.ALLOC_FAILED: "Memory allocation failed.",
    ResamplerErrorCode.BAD_STATE: "Bad resampler state.",
    ResamplerErrorCode.INVALID_ARG: "Invalid argument.",
    ResamplerErrorCode.PTR_OVERLAP: "Input and output buffers overlap.",
}


def strerror(err: int) -> str:
    """resample.c:1222-1239 (identical strings, incl. the default case)."""
    try:
        return _MESSAGES[ResamplerErrorCode(err)]
    except (ValueError, KeyError):
        return "Unknown error. Bad error code or strange version mismatch."


class ResamplerError(Exception):
    """Raised where the JS layer would throw the decoded C error string
    (src/index.ts:63-65, :104-106)."""

    def __init__(self, code: ResamplerErrorCode):
        self.code = ResamplerErrorCode(code)
        super().__init__(strerror(code))
