"""Typed error taxonomy for user-facing failures.

Copy of ltx_tpu/core/errors.py, class for class and message for message
(tests/test_torch_static.py holds the two against each other), so that the
port raises what the reference raises without importing it.
"""

from __future__ import annotations


class LTXError(Exception):
    """Base for all user-facing errors."""


class ModelNotLoadedError(LTXError):
    """A required model component is not loaded (LTXVideo.swift:68)."""

    def __init__(self, component: str):
        super().__init__(f"Model component not loaded: {component}")
        self.component = component


class InvalidConfigurationError(LTXError, ValueError):
    """Invalid generation configuration (LTXVideo.swift:71).

    Also a ValueError so pre-taxonomy callers catching ValueError keep
    working.
    """

    def __init__(self, message: str):
        super().__init__(f"Invalid configuration: {message}")


class WeightLoadingFailedError(LTXError):
    """Failed to load/map weights from a file (LTXVideo.swift:77)."""

    def __init__(self, message: str):
        super().__init__(f"Failed to load weights: {message}")


class DownloadFailedError(LTXError):
    """Failed to download a model component (LTXVideo.swift:80)."""

    def __init__(self, message: str):
        super().__init__(f"Download failed: {message}")


class VideoProcessingFailedError(LTXError):
    """Video decode/post-processing failure (LTXVideo.swift:83)."""

    def __init__(self, message: str):
        super().__init__(f"Video processing failed: {message}")


class GenerationFailedError(LTXError):
    """Generation failed (LTXVideo.swift:86)."""

    def __init__(self, message: str):
        super().__init__(f"Generation failed: {message}")


class InvalidFrameCountError(InvalidConfigurationError):
    """Frame count must be 8n + 1 (LTXVideo.swift:92)."""

    def __init__(self, count: int):
        LTXError.__init__(
            self,
            f"Invalid frame count: {count}. Must be 8n + 1 "
            "(e.g., 9, 17, 25, 33, 41, 49, 57, 65, 73, 81, 89, 97)",
        )


class InvalidDimensionsError(InvalidConfigurationError):
    """Width/height must be divisible by 32 (LTXVideo.swift:95)."""

    def __init__(self, width: int, height: int):
        LTXError.__init__(
            self,
            f"Invalid dimensions: {width}x{height}. "
            "Both must be divisible by 32",
        )


class TextEncodingFailedError(LTXError):
    """Text encoding failed (LTXVideo.swift:98)."""

    def __init__(self, message: str):
        super().__init__(f"Text encoding failed: {message}")


class FileNotFoundLTXError(LTXError, FileNotFoundError):
    """Referenced file does not exist (LTXVideo.swift:101)."""

    def __init__(self, path: str):
        super().__init__(f"File not found: {path}")
        self.path = path


class InvalidLoRAError(LTXError):
    """Malformed LoRA weights/keys (LTXVideo.swift:104)."""

    def __init__(self, message: str):
        super().__init__(f"Invalid LoRA: {message}")


class ExportFailedError(LTXError):
    """Video/audio export failed (LTXVideo.swift:107)."""

    def __init__(self, message: str):
        super().__init__(f"Export failed: {message}")
