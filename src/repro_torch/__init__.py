"""PyTorch + CUDA port of the dynamic overlay (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s layout — ``configs/``, ``kernels/``,
``core/``, ``models/``, ``serving/``, ``optim/``, ``data/``,
``checkpoint/``, ``runtime/``, ``launch/`` — so every module has a
counterpart a reader can find by name.  It imports ``torch`` and nothing of
``jax`` or ``repro``; what it needs from the reference it carries as its own
copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).  The Pallas kernels on the
serving and training paths (vmul_reduce, rmsnorm, flash_attention) are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built by ``nvcc`` at
first use (:mod:`repro_torch.kernels.native`).
"""
