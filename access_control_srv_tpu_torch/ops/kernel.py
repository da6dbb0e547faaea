"""The dense batched decision kernel of the port.

``DecisionKernel`` keeps the JAX package's API (``evaluate``,
``evaluate_async`` returning a materialize thunk, the pow2 batch bucket and
the ACL / no-ACL dispatch on the batch's content).  Its device work is one
call of ``decide_dense``: on CUDA tensors that launches the hand-written
kernel ``ops/csrc/decide_dense.cu``; on CPU tensors it runs the plain
PyTorch version ``ops/kernel_ref.decide_dense_ref``.  A build or launch
failure on the card raises; nothing gives way to the plain version there.

Not ported yet, and refused with ``NotImplementedError``: trees whose
targets carry relation paths (the ReBAC relation planes) and the explain
output.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .carry import (
    batch_from_numpy,
    lead_padding,
    pad_cols,
    pow2_bucket,
    tables_from_numpy,
)
from .compile import CompiledPolicies
from .encode import RequestBatch
from .kernel_ref import BIG, decide_dense_ref

__all__ = [
    "BIG", "DecisionKernel", "LAUNCHES", "decide_dense", "lead_padding",
    "pack_rule_key", "pad_cols", "pow2_bucket", "resolve_device",
    "tree_needs_hr", "tree_needs_rel", "unpack_rule_key",
]

# kernel launches per wrapper, counted where the wrapper launches
LAUNCHES = {"decide_dense": 0}

# the argument order of csrc/decide_dense.cu (checked against the
# library's own layout string when it loads)
TABLE_ARRAYS = (
    "t_n_subjects", "t_role", "t_has_role", "t_has_scoping", "t_hr_check",
    "t_skip_acl", "t_sub_ids", "t_sub_vals", "t_act_ids", "t_act_vals",
    "t_ent_vals", "t_ent_w", "t_ent_tails", "t_op_vals", "t_prop_vals",
    "t_prop_sfx", "t_has_props", "t_n_res", "t_rs_idx",
    "set_valid", "set_ca", "set_has_target", "set_target",
    "pol_valid", "pol_ca", "pol_effect", "pol_cacheable", "pol_has_target",
    "pol_target", "pol_has_subjects", "pol_n_rules", "pol_eff_ctx",
    "pol_has_props", "pol_ent_vals",
    "rule_valid", "rule_effect", "rule_cacheable_raw", "rule_cacheable_eff",
    "rule_has_target", "rule_target", "rule_cond", "acl_consts",
)
ROW_ARRAYS = (
    "r_sub_ids", "r_sub_vals", "r_roles", "r_act_ids", "r_act_vals",
    "r_ent_vals", "r_ent_e", "r_ent_valid", "r_prop_vals", "r_prop_sfx",
    "r_prop_run", "r_prop_tail", "r_op_vals", "r_ra3", "r_ra2", "r_n_ra",
    "r_ctx_present", "r_n_entity_attrs", "r_has_props", "r_acl_short",
    "r_acl_ent", "r_acl_inst", "r_acl_hr", "r_hr_roles", "r_subject_id",
    "r_own_runs", "r_own_bits",
)
BATCH_ARRAYS = ("rgx_set", "pfx_neq", "cond_true", "cond_abort", "cond_code")
OUTPUTS = ("out_decision", "out_cacheable", "out_status")
DIMS = (
    "B", "T", "S", "KP", "KR", "KS", "KA", "KE", "KO", "KPR",
    "NSUB", "NROLE", "NACT", "NR", "NP", "NOP", "NRA", "NHR",
    "NACLE", "NACLI", "NHRR", "NRU", "NWORDS", "W", "E", "C", "CSTRIDE",
)

# bounds of the kernel's per-thread bitmask state (csrc MAX_*)
_LIMITS = {"NR": 32, "NOP": 32, "NACLE": 32, "NACLI": 64, "NHRR": 32,
           "KE": 8}


def tree_needs_hr(arrays: dict) -> bool:
    """Static gate for stage B: only target rows carrying BOTH subjects
    and a scoping entity can fail the HR check."""
    return bool(
        (np.asarray(arrays["t_has_scoping"])
         & (np.asarray(arrays["t_n_subjects"]) > 0)).any()
    )


def tree_needs_rel(arrays: dict) -> bool:
    """True when some target row carries a relation-path requirement."""
    t = arrays.get("t_rel_idx")
    return t is not None and bool((np.asarray(t) >= 0).any())


def pack_rule_key(pos, effect, cacheable):
    """Combine-reduction key: rule position in the high bits, (effect,
    cacheable) payload in the low 3 (int32, sentinel ``BIG``)."""
    return (pos << 3) | (effect << 1) | cacheable.to(torch.int32)


def unpack_rule_key(key):
    """(effect, cacheable) payload of a pack_rule_key winner."""
    return (key >> 1) & 3, key & 1


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; asking for CUDA without one raises
    (the port never carries on silently on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch version"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load("decide_dense")
        lib.acs_decide_dense_layout.restype = ctypes.c_char_p
        lib.acs_decide_dense_smem.restype = ctypes.c_longlong
        lib.acs_decide_dense_smem.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.acs_decide_dense.restype = ctypes.c_int
        lib.acs_decide_dense.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.acs_max_smem_optin.restype = ctypes.c_int
        lib.acs_cuda_error_string.restype = ctypes.c_char_p
        lib.acs_cuda_error_string.argtypes = [ctypes.c_int]
        names = TABLE_ARRAYS + ROW_ARRAYS + BATCH_ARRAYS + OUTPUTS
        want = ",".join(names) + ",|" + ",".join(DIMS) + ","
        have = lib.acs_decide_dense_layout().decode()
        if have != want:
            raise RuntimeError(
                "decide_dense.cu argument layout differs from the host's:\n"
                f"  library: {have}\n  host:    {want}"
            )
        _lib = lib
    return _lib


def _dims(c: dict, r: dict) -> dict[str, int]:
    S, KP, KR = c["rule_valid"].shape
    return {
        "B": r["r_n_ra"].shape[0], "T": c["t_role"].shape[0],
        "S": S, "KP": KP, "KR": KR,
        "KS": c["t_sub_ids"].shape[1], "KA": c["t_act_ids"].shape[1],
        "KE": c["t_ent_vals"].shape[1], "KO": c["t_op_vals"].shape[1],
        "KPR": c["t_prop_vals"].shape[1],
        "NSUB": r["r_sub_ids"].shape[1], "NROLE": r["r_roles"].shape[1],
        "NACT": r["r_act_ids"].shape[1], "NR": r["r_ent_vals"].shape[1],
        "NP": r["r_prop_vals"].shape[1], "NOP": r["r_op_vals"].shape[1],
        "NRA": r["r_ra3"].shape[1], "NHR": r["r_acl_hr"].shape[1],
        "NACLE": r["r_acl_inst"].shape[1], "NACLI": r["r_acl_inst"].shape[2],
        "NHRR": r["r_hr_roles"].shape[1], "NRU": r["r_own_runs"].shape[1],
        "NWORDS": r["r_own_bits"].shape[1],
        "W": r["rgx_set"].shape[0], "E": r["rgx_set"].shape[1],
        "C": r["cond_true"].shape[0], "CSTRIDE": r["cond_true"].shape[1],
    }


def threads_for(T: int) -> int:
    """Threads per block: one warp per 32 target rows, 64 to 256."""
    return min(256, max(64, -(-T // 32) * 32))


class LaunchArgs(NamedTuple):
    """One launch's C arguments: the output tensor, the pointer array
    (tables, rows, batch arrays, outputs, in ``acs_decide_dense_layout``
    order), the shape-int array, the shapes and the threads per block."""

    out: torch.Tensor
    ptrs: ctypes.Array
    dims: ctypes.Array
    shape: dict
    threads: int


def pack_args(c: dict, r: dict) -> LaunchArgs:
    """Check the tensors (one device, contiguous, int32 or bool, shapes
    within the kernel's limits), allocate the outputs and pack the C
    arguments of one launch."""
    dev = r["r_n_ra"].device
    dims = _dims(c, r)
    for k, limit in _LIMITS.items():
        if dims[k] > limit:
            raise ValueError(f"decide_dense: {k}={dims[k]} exceeds the "
                             f"kernel's limit {limit}")
    names = TABLE_ARRAYS + ROW_ARRAYS + BATCH_ARRAYS
    tensors = [c[k] for k in TABLE_ARRAYS]
    tensors += [r[k] for k in ROW_ARRAYS + BATCH_ARRAYS]
    for name, t in zip(names, tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"decide_dense: {name} must be contiguous on "
                             f"{dev}")
        if t.dtype not in (torch.int32, torch.bool):
            raise ValueError(f"decide_dense: {name} has dtype {t.dtype}")
    out = torch.empty((3, dims["B"]), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in tensors]
    ptrs += [out[i].data_ptr() for i in range(3)]
    return LaunchArgs(
        out=out,
        ptrs=(ctypes.c_int64 * len(ptrs))(*ptrs),
        dims=(ctypes.c_int32 * len(DIMS))(*(dims[k] for k in DIMS)),
        shape=dims,
        threads=threads_for(dims["T"]),
    )


def _launch(c: dict, r: dict, with_acl: bool, with_hr: bool) -> torch.Tensor:
    args = pack_args(c, r)
    dev = args.out.device
    lib = _library()
    smem = lib.acs_decide_dense_smem(ctypes.addressof(args.dims),
                                     len(args.dims), int(with_acl))
    with torch.cuda.device(dev):
        limit = lib.acs_max_smem_optin()
        if smem > limit:
            raise ValueError(
                f"decide_dense: the tree needs {smem} bytes of shared memory "
                f"per block, the device allows {limit}"
            )
        code = lib.acs_decide_dense(
            ctypes.addressof(args.ptrs), len(args.ptrs),
            ctypes.addressof(args.dims), len(args.dims), int(with_acl),
            int(with_hr), args.threads,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if code != 0:
        msg = ("argument count mismatch" if code < 0
               else lib.acs_cuda_error_string(code).decode())
        raise RuntimeError(f"decide_dense launch failed ({code}): {msg}")
    LAUNCHES["decide_dense"] += 1
    return args.out


def decide_dense(c: dict, r: dict, with_acl: bool, with_hr: bool
                 ) -> torch.Tensor:
    """Dense decisions for a whole batch -> int32 [3, B] (decision,
    cacheable, status).  CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    if r["r_n_ra"].device.type == "cuda":
        return _launch(c, r, with_acl, with_hr)
    return torch.stack(decide_dense_ref(c, r, with_acl, with_hr))


class DecisionKernel:
    """Compiled-policy decision kernel: the policy tables live on
    ``device`` (``None`` = the CUDA device) and each batch is one call of
    ``decide_dense``."""

    def __init__(self, compiled: CompiledPolicies, device=None,
                 explain: bool = False):
        if not compiled.supported:
            raise ValueError(
                f"policy tree unsupported by kernel: {compiled.unsupported_reason}"
            )
        if explain:
            raise NotImplementedError(
                "explain output: not ported yet (serving-shell slice)"
            )
        if tree_needs_rel(compiled.arrays):
            raise NotImplementedError(
                "relation-path targets (ReBAC relation planes): not ported "
                "yet (ReBAC slice)"
            )
        self.compiled = compiled
        self.device = resolve_device(device)
        self.with_hr = tree_needs_hr(compiled.arrays)
        self._c = tables_from_numpy(compiled.arrays, self.device,
                                    keys=TABLE_ARRAYS)

    def evaluate(self, batch: RequestBatch):
        """Returns (decision, cacheable, status) numpy arrays [B]."""
        return self.evaluate_async(batch)()

    def evaluate_async(self, batch: RequestBatch):
        """Copy the batch to the device and launch WITHOUT waiting for the
        result; returns a zero-arg callable that materializes the
        (decision, cacheable, status) tuple.  The batch axis is padded to
        a power-of-two bucket (``lead_padding``).

        Only batches carrying ACL pairs take the kernel variant with the
        verifyACL create-path scan; the no-pair variant is exact for
        everything else."""
        with_acl = bool((np.asarray(batch.arrays["r_acl_ent"]) >= 0).any())
        b, r = batch_from_numpy(batch, self.device, keys=ROW_ARRAYS)
        out = decide_dense(self._c, r, with_acl, self.with_hr)
        if self.device.type == "cpu":
            host = out.numpy()
            return lambda: tuple(host[i, :b] for i in range(3))
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def materialize():
            done.synchronize()
            arr = host.numpy()
            return tuple(arr[i, :b] for i in range(3))

        return materialize
