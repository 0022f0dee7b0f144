"""The benchmark's plain reference: Speex's float resampler in NumPy and
plain PyTorch, with its own copy of the filter design.  It imports
nothing of the program under test."""
