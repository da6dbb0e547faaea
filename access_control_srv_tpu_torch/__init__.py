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
- ``native``  -- the C++ wire-batch encoder (host code, built by g++ into
  ``_build/`` on first use) behind the evaluator's wire path.
- ``srv``     -- the hybrid evaluator (isAllowed and whatIsAllowed batches,
  the decision cache, token / HR-scope preparation, the native wire
  path), the identity clients, caches and resource adapters, and the
  direct-mode audit sweep (``srv/audit_sweep.py``).  ``srv/gen`` holds
  the generated protobuf module, which only the gRPC identity classes
  import.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they raise when CUDA is asked for and unavailable.
"""

__version__ = "0.1.0"
