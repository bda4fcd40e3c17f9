"""Target-specific parts of the device runtime's host side.

Importing this package registers every variant (the analogue of
linking the target-dependent objects of the LLVM device runtime).  The
device side of each target is ``csrc/rt/targets/``.
"""
from repro_torch.core.targets import cpu as _cpu  # noqa: F401
from repro_torch.core.targets import cuda as _cuda  # noqa: F401
from repro_torch.core.targets import generic as _generic  # noqa: F401
