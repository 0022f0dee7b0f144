from .native import NativeStager, PyStager, load_runtime, make_stager
from .fleet import FleetResampler
from .multifleet import MultiFleet

__all__ = ["NativeStager", "PyStager", "load_runtime", "make_stager",
           "FleetResampler", "MultiFleet"]
