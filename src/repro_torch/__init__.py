"""PyTorch/CUDA port of ``repro``, written for one NVIDIA H100.

It imports ``torch``, numpy and the standard library only, never JAX or
the ``repro`` package.  Public layouts match the reference's, so params
cross between the two through numpy (``weights.params_from_numpy``).
Kernels route by tensor device: a CUDA tensor launches the hand-written
kernel in ``kernels/csrc``, a CPU tensor takes its plain PyTorch version.

It serves the dense LM decoders (``serving``, ``launch.serve``) and trains
the paper's Table-2 CNN through both layers of BPT
(``core.bpt_trainer.BPTTrainer``).
"""

__version__ = "0.1.0"
