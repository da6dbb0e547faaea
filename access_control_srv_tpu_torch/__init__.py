"""PyTorch/CUDA port of the ABAC decision framework.

A second package beside ``access_control_srv_tpu`` (the JAX reference),
with the same layout so every module has a counterpart of the same name:

- ``models``  -- the policy/request data model and URN vocabulary (copy).
- ``core``    -- the scalar policy-decision oracle (copy); it serves the
  requests the device kernel cannot represent.
- ``ops``     -- string interner, policy compiler and request encoder
  (copies, numpy), the host-to-device carry (``ops/carry.py``), and the
  dense decision kernel: a hand-written CUDA kernel for ``sm_90a``
  (``ops/csrc/decide_dense.cu``) beside its plain PyTorch version
  (``ops/kernel_ref.py``).
- ``srv``     -- the hybrid evaluator's uncached batch path.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they raise when CUDA is asked for and unavailable.
"""

__version__ = "0.1.0"
