"""PyTorch/CUDA port of ``gyeeta_tpu``'s flow-event fold path.

A second package beside the JAX one, with the same module layout and
names, so each counterpart is easy to find: ``utils/hashing.py``,
``ingest/{wire,decode}.py``, ``sim/partha.py``, ``sketch/*``,
``engine/{table,aggstate,step}.py`` and ``query/readback.py``.

The two Pallas kernels of the reference
(``gyeeta_tpu/sketch/pallas_scatter.py``) are hand-written CUDA kernels
here (``csrc/scatter.cu``, bound in ``sketch/scatter.py``). Entry points
take an explicit ``device``: CUDA by default, and they raise when no GPU
is present unless the caller asks for ``device="cpu"``, where each kernel
wrapper runs its plain PyTorch version.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``gyeeta_tpu``: what it needs of the reference it keeps as its own copy.
"""
