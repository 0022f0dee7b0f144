from .presets import Preset, PRESETS, get_preset, describe

__all__ = ["Preset", "PRESETS", "get_preset", "describe"]
