"""PyTorch/CUDA port of the ABAC decision framework.

A second package beside ``access_control_srv_tpu`` (the JAX reference),
with the same layout so every module has a counterpart of the same name:

- ``models``  -- the policy/request data model and URN vocabulary (copy).
- ``core``    -- the scalar policy-decision oracle (copy); it serves the
  requests the device kernel cannot represent.
- ``ops``     -- string interner, policy compiler and request encoder
  (copies, numpy), the host-to-device carry (``ops/carry.py``), the
  decision kernels (dense, ``ops/kernel.py``; signature path,
  ``ops/prefilter.py``), the reverse query (``ops/reverse.py``) and the
  permission lattice (``ops/lattice.py``, host only).  Every kernel is
  hand-written CUDA for ``sm_90a`` (``ops/csrc/*.cu``) beside its plain
  PyTorch version (``ops/*_ref.py``).
- ``srv``     -- the hybrid evaluator's uncached batch path (isAllowed and
  whatIsAllowed) and the direct-mode audit sweep (``srv/audit_sweep.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they raise when CUDA is asked for and unavailable.
"""

__version__ = "0.1.0"
