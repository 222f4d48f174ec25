"""repro_torch — HiFrames on PyTorch and CUDA: the port of ``repro``.

``from repro_torch import hiframes as hf`` is the public surface.  Plans run
on the card by default (hand-written CUDA kernels for ``sm_90a``) and on the
CPU only when the caller asks for ``ExecConfig(device="cpu")``.  The LM
substrate's dense serving path is ``repro_torch.models`` and
``repro_torch.launch.steps``, on the card by default too.
"""
from . import core
from .core import api as hiframes  # `from repro_torch import hiframes as hf`

__version__ = "0.1.0"
