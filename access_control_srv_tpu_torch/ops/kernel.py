"""The port's decision kernels and their launch wrappers.

``DecisionKernel`` keeps the JAX package's API (``evaluate``,
``evaluate_async`` returning a materialize thunk, the pow2 batch bucket and
the ACL / no-ACL dispatch on the batch's content).  Its device work is one
call of ``decide_dense``: on CUDA tensors that launches the hand-written
kernel ``ops/csrc/decide_dense.cu`` (the rows program of
``csrc/rows_core.cuh``, one block per ``RT`` rows, ``rows_tiles``); on CPU
tensors it runs the plain PyTorch version
``ops/kernel_ref.decide_dense_ref``.  A build or launch
failure on the card raises; nothing gives way to the plain version there.

The signature path's three kernels (``ops/prefilter.PrefilteredKernel``)
are wrapped here the same way: ``sig_planes`` (``csrc/sig_planes.cu``),
``sig_decide`` (``csrc/sig_decide.cu``) and ``decide_grouped``
(``csrc/decide_grouped.cu``), with plain versions in
``ops/prefilter_ref.py``.  The reverse query's kernel
(``ops/reverse.ReverseQueryKernel``) is ``wia_planes``
(``csrc/wia_planes.cu``, plain version ``ops/reverse_ref.py``).  The
sharded programs' kernels (``parallel/rule_shard.py``,
``parallel/pod_shard.py``) are ``rule_chunk`` and ``set_chunk`` (the
rows program in the rule-chunk and set-chunk modes of
``csrc/shard_chunk.cu``; ``set_chunk`` on a pod shard's live target rows)
and ``shard_tail`` (``csrc/shard_tail.cu``, several rows per block; the
rule-sharded tables' pointers packed once, ``TailTables``), with plain
versions in ``ops/shard_ref.py``.
Every wrapper checks its library's argument layout string when it loads
and counts its launches in ``LAUNCHES``.

Trees whose targets carry relation paths (ReBAC) take each kernel's
``with_rel`` variant, which folds the per-batch relation-closure
bitplanes (``r_rel_runs`` / ``r_rel_bits``, ``ops/relation.py``) into the
HR gate.

Explain mode (``explain=True`` on ``decide_dense``, ``decide_grouped``,
``sig_decide``, ``set_chunk`` and ``shard_tail``, and on
``DecisionKernel``) adds the fourth output of the JAX programs: one int32
per row, the provenance code ``(flat_pos << 2) | kind`` that
``srv/explain.py`` decodes.  It is a template flag of each kernel; the
explain-off launches run the variants they ran before.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .carry import (
    batch_from_numpy,
    half_pow2_bucket,
    lead_padding,
    pad_cols,
    pow2_bucket,
    tables_from_numpy,
)
from .compile import CompiledPolicies
from .encode import RequestBatch
from .kernel_ref import BIG, decide_dense_ref
from .prefilter_ref import (
    decide_grouped_ref,
    plane_names,
    sig_decide_ref,
    sig_planes_ref,
)
from .reverse_ref import PLANE_KEYS, WIA_ROWS, WIA_TABLES, wia_planes_ref
from .shard_ref import (
    MODE_RULE,
    MODE_SET,
    live_rows,
    merge_width,
    rule_chunk_ref,
    set_chunk_ref,
    shard_tail_ref,
)

__all__ = [
    "BIG", "DecisionKernel", "LAUNCHES", "ORIG_TABLE", "Runner",
    "SlotLayout", "TailTables",
    "decide_dense", "decide_grouped", "grouped_layout",
    "lead_padding", "load_libraries", "pack_rule_key", "pad_cols",
    "pow2_bucket",
    "resolve_device", "rows_tiles", "rule_chunk", "set_chunk", "shard_tail",
    "sig_decide", "sig_planes", "slot_layout", "tree_needs_hr",
    "tree_needs_rel", "unpack_rule_key", "wia_planes",
]

# kernel launches per wrapper, counted where the wrapper launches
LAUNCHES = {"decide_dense": 0, "sig_planes": 0, "sig_decide": 0,
            "decide_grouped": 0, "wia_planes": 0, "rule_chunk": 0,
            "set_chunk": 0, "shard_tail": 0}

# the argument order of csrc/decide_dense.cu (checked against the
# library's own layout string when it loads)
TABLE_ARRAYS = (
    "t_n_subjects", "t_role", "t_has_role", "t_has_scoping", "t_hr_check",
    "t_skip_acl", "t_sub_ids", "t_sub_vals", "t_act_ids", "t_act_vals",
    "t_ent_vals", "t_ent_w", "t_ent_tails", "t_op_vals", "t_prop_vals",
    "t_prop_sfx", "t_has_props", "t_n_res", "t_rs_idx", "t_rel_idx",
    "t_rel_direct", "set_valid", "set_ca", "set_has_target", "set_target",
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
    "r_own_runs", "r_own_bits", "r_rel_runs", "r_rel_bits",
)
BATCH_ARRAYS = ("rgx_set", "pfx_neq", "cond_true", "cond_abort", "cond_code")
# the fourth output is written by the explain variants only (null otherwise)
OUTPUTS = ("out_decision", "out_cacheable", "out_status", "out_explain")
# each compacted rule slot's original flat position: the explain variants
# map the winning rule through it when the rule axis was compacted
# (``prefilter.compact_rules(..., explain=True)``); null otherwise
ORIG_TABLE = "rule_orig_flat"
# the argument order of the dense program (csrc/decide_core.cuh ACS_PTRS)
DENSE_PTRS = TABLE_ARRAYS + (ORIG_TABLE,) + ROW_ARRAYS + BATCH_ARRAYS \
    + OUTPUTS
DIMS = (
    "B", "T", "S", "KP", "KR", "KS", "KA", "KE", "KO", "KPR",
    "NSUB", "NROLE", "NACT", "NR", "NP", "NOP", "NRA", "NHR",
    "NACLE", "NACLI", "NHRR", "NRU", "NWORDS", "NRU_REL", "NWORDS_REL", "W",
    "E", "C", "CSTRIDE",
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


# the argument order of csrc/sig_planes.cu: the stacked varying tables it
# reads, the shared policy arrays, the pseudo-requests, the planes (the HR
# planes, then the relation planes, each null where the variant has none)
# and the scratch of the per-target records
SIG_PLANES_INPUTS = (
    "t_n_subjects", "t_role", "t_has_role", "t_has_scoping", "t_hr_check",
    "t_skip_acl", "t_sub_ids", "t_sub_vals", "t_act_ids", "t_act_vals",
    "t_ent_vals", "t_ent_w", "t_ent_tails", "t_op_vals", "t_prop_vals",
    "t_prop_sfx", "t_has_props", "t_n_res", "t_rs_idx", "t_rel_idx",
    "t_rel_direct",
    "rule_effect", "rule_target", "pol_target", "set_target",
    "pol_valid", "pol_effect", "pol_has_props", "pol_ent_vals",
)
SIG_PSEUDO = (
    "r_act_ids", "r_act_vals", "r_ent_vals", "r_ent_e", "r_ent_valid",
    "r_prop_vals", "r_prop_sfx", "r_prop_run", "r_prop_tail", "r_op_vals",
    "r_has_props", "rgx_set", "pfx_neq",
)
SIG_SCRATCH = ("comp",)
SIG_PLANES_PTRS = SIG_PLANES_INPUTS + SIG_PSEUDO + plane_names(True, True) \
    + SIG_SCRATCH
SIG_PLANES_DIMS = ("G", "T", "S", "KP", "KR", "KS", "KA", "KE", "KO", "KPR",
                   "NACT", "NR", "NP", "NOP", "W", "E")
# threads per block of both sig_planes launches, and the int32 words of a
# per-(group, target) record of its component pass (csrc SP_REC)
SIG_PLANES_THREADS = 256
SIG_COMP_WORDS = 8

# every region ``carve_plan`` lays out starts at a multiple of this
CARVE_ALIGN = 256
_TORCH_DTYPE = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int32): torch.int32}


class Region(NamedTuple):
    """A region of a carved allocation: its byte offset, shape, numpy
    dtype and (contiguous) strides in elements."""

    offset: int
    shape: tuple
    dtype: np.dtype
    strides: tuple


def carve_plan(specs) -> tuple[dict, int]:
    """Regions of one allocation for ``specs`` ((name, shape, numpy dtype,
    room): ``room`` the elements to reserve, ``None`` for the shape's),
    back to back, each ``CARVE_ALIGN``-aligned -> ({name: Region}, total
    bytes, a multiple of ``CARVE_ALIGN``)."""
    plan, off = {}, 0
    for name, shape, dtype, room in specs:
        dt = np.dtype(dtype)
        shape = tuple(int(x) for x in shape)
        strides, step = [], 1
        for x in reversed(shape):
            strides.append(step)
            step *= x
        plan[name] = Region(off, shape, dt, tuple(reversed(strides)))
        n = step if room is None else int(room)
        off = -(-(off + n * dt.itemsize) // CARVE_ALIGN) * CARVE_ALIGN
    return plan, off


def carve(buf, plan: dict) -> dict:
    """The regions of ``plan`` as views of ``buf`` (a flat uint8 torch
    tensor or numpy array, its length a multiple of ``CARVE_ALIGN``) in
    their shapes and dtypes."""
    if isinstance(buf, np.ndarray):
        return {name: buf[r.offset:r.offset + math.prod(r.shape)
                          * r.dtype.itemsize].view(r.dtype).reshape(r.shape)
                for name, r in plan.items()}
    typed: dict = {}
    out = {}
    for name, r in plan.items():
        base = typed.get(r.dtype)
        if base is None:
            base = typed[r.dtype] = buf.view(_TORCH_DTYPE[r.dtype])
        out[name] = base.as_strided(r.shape, r.strides,
                                    r.offset // r.dtype.itemsize)
    return out

# the argument order of csrc/sig_decide.cu
SIG_DECIDE_INV = (
    "acl_consts", "set_valid", "set_ca", "set_has_target", "pol_valid",
    "pol_ca", "pol_effect", "pol_cacheable", "pol_has_target",
    "pol_has_subjects", "pol_n_rules", "pol_eff_ctx",
)
SIG_DECIDE_CS = (
    "rule_valid", "rule_effect", "rule_cacheable_raw", "rule_cacheable_eff",
    "rule_has_target", "rule_cond",
)
SIG_DECIDE_MAPS = ("slot_g", "mega_rows", "grid2row", "gp_orig")
SIG_DECIDE_PTRS = SIG_DECIDE_INV + SIG_DECIDE_CS + (ORIG_TABLE,) \
    + plane_names(True, True) + SIG_DECIDE_MAPS + OUTPUTS
# the packed row's columns the kernel reads, by the offset dim naming them
SIG_ROW_OFFSETS = (
    ("O_SUB_IDS", "r_sub_ids"), ("O_SUB_VALS", "r_sub_vals"),
    ("O_ROLES", "r_roles"), ("O_ACT_IDS", "r_act_ids"),
    ("O_ACT_VALS", "r_act_vals"), ("O_N_ENT_ATTRS", "r_n_entity_attrs"),
    ("O_N_RA", "r_n_ra"), ("O_ACL_SHORT", "r_acl_short"),
    ("O_CTX_PRESENT", "r_ctx_present"), ("O_OWN_RUNS", "r_own_runs"),
    ("O_OWN_BITS", "r_own_bits"), ("O_REL_RUNS", "r_rel_runs"),
    ("O_REL_BITS", "r_rel_bits"), ("O_COND_TRUE", "cond_true"),
    ("O_COND_ABORT", "cond_abort"), ("O_COND_CODE", "cond_code"),
)
SIG_DECIDE_DIMS = (
    "NSLOT", "R", "S", "KP", "KR", "KS", "NR", "NOP", "WROW", "NSUB",
    "NROLE", "NACT", "NRU", "NWORDS", "NRU_REL", "NWORDS_REL", "C",
) + tuple(o for o, _ in SIG_ROW_OFFSETS) + ("NEEDS_PAIRS", "RB", "PT")
# threads per sig_decide block, and how it sizes its blocks: rows of a slot
# per block, and the shared-memory bytes of a staged rule tile (10 bytes a
# rule position; a set whose rules exceed them is staged in policy tiles)
SIG_DECIDE_THREADS = 256
SIG_STAGE = {"rows": 8, "rules": 64 * 1024}

# the argument order of csrc/decide_grouped.cu: the dense program's
# pointers, then the slot layout; its shape ints after the dense ones: the
# slot count and width, rows per block, policies per staged rule tile
GROUPED_PTRS = DENSE_PTRS + ("slot_g", "grid2row", "gp_orig")
GROUPED_DIMS = ("NSLOT", "R", "RT", "PT")
# threads per decide_grouped block, and how it sizes its blocks: rows per
# block and the shared-memory bytes of their per-row results, and a rule
# tile's bytes (9 a rule position; a set whose rules exceed them is staged
# in policy tiles)
GROUPED_THREADS = 256
GROUPED_STAGE = {"rows": 16, "row_bytes": 64 * 1024, "rules": 32 * 1024}

# the block shape of the rows program (csrc/rows_core.cuh: decide_dense,
# rule_chunk and set_chunk) after its other shape ints: request rows per
# block, policies per staged rule tile
ROWS_DIMS = ("RT", "PT")
# the rows program's dense mode (csrc/decide_core.cuh RowMode; the shard
# modes are shard_ref's MODE_RULE and MODE_SET)
MODE_DENSE = 0
# threads per rows-program block, and how it sizes its blocks
# (``rows_tiles``): at most ``rows`` rows per block, fewer where the batch
# would give the card under ``blocks_per_sm`` blocks per SM, and a block's
# shared memory within ``block_bytes`` (two blocks fit an H100 SM); a rule
# tile's bytes (9 a rule position; a set whose rules exceed them is staged
# in policy tiles)
ROWS_STAGE = {"threads": 256, "rows": 16, "blocks_per_sm": 2,
              "block_bytes": 112 * 1024, "rules": 16 * 1024}
# the SM count the tiles are sized for where the tensors lie on the CPU
# (the g++ stand-in of the tests): an H100's
HOST_SM_COUNT = 132

_libs: dict = {}
_sm_counts: dict = {}
# the sizes asked of the libraries and the carved layouts, by library or
# kernel and shapes (rows_tiles, wia_tiles, the sig_planes plan)
_tiles: dict = {}

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# the shared-memory sizing and occupancy entry points of the libraries
# that have them, typed once when the library loads: name -> {entry:
# (restype, argtypes)}
_SIZING = {
    "decide_dense": {
        "acs_decide_dense_smem": (ctypes.c_longlong, [_VP] + [_INT] * 3),
        "acs_decide_dense_occupancy": (_INT, [_VP] + [_INT] * 6),
        "acs_rows_tile": (_INT, [_VP, _INT, _INT, _INT, _VP, _VP])},
    "shard_chunk": {
        "acs_shard_chunk_smem": (ctypes.c_longlong, [_VP] + [_INT] * 4),
        "acs_shard_chunk_occupancy": (_INT, [_VP] + [_INT] * 7),
        "acs_rows_tile": (_INT, [_VP, _INT, _INT, _INT, _VP, _VP])},
    "shard_tail": {
        "acs_shard_tail_block": (_INT, [_INT, _VP]),
        "acs_shard_tail_floor": (_INT, [_INT] * 3 + [_VP]),
        "acs_shard_tail_occupancy": (_INT, [_INT] * 3)},
    "decide_grouped": {
        "acs_decide_grouped_smem": (ctypes.c_longlong, [_VP] + [_INT] * 4),
        "acs_decide_grouped_occupancy": (_INT, [_VP] + [_INT] * 6)},
    "sig_decide": {
        "acs_sig_decide_smem": (ctypes.c_longlong, [_VP] + [_INT] * 2),
        "acs_sig_decide_occupancy": (_INT, [_VP, _INT, _VP] + [_INT] * 5)},
    "sig_planes": {
        "acs_sig_planes_floor": (_INT, [_VP] + [_INT] * 2 + [_VP]),
        "acs_sig_planes_occupancy": (_INT, [_INT] * 3)},
    "wia_planes": {
        "acs_wia_planes_tile": (_INT, [_VP, _INT, _INT, _VP, _VP]),
        "acs_wia_planes_floor": (_INT, [_VP] + [_INT] * 2 + [_VP]),
        "acs_wia_planes_occupancy": (_INT, [_VP] + [_INT] * 2)},
}


def _library(name: str, ptr_names: tuple, dim_names: tuple, flags: int):
    """The loaded library of ``csrc/<name>.cu`` (built first if needed),
    its entry point typed as (ptrs, n_ptrs, dims, n_dims, ``flags`` ints,
    threads, stream), its ``_SIZING`` entry points and the device's
    shared-memory limit typed, and its argument layout checked against
    the host's (``ptr,...,|dim,...,``)."""
    lib = _libs.get(name)
    if lib is None:
        from . import cuda_build

        lib = cuda_build.load(name)
        layout = getattr(lib, f"acs_{name}_layout")
        layout.restype = ctypes.c_char_p
        entry = getattr(lib, f"acs_{name}")
        entry.restype = ctypes.c_int
        entry.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_int] * (flags + 1) + [ctypes.c_void_p]
        )
        for fn, (restype, argtypes) in _SIZING.get(name, {}).items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        lib.acs_max_smem_optin.restype = ctypes.c_int
        lib.acs_cuda_error_string.restype = ctypes.c_char_p
        lib.acs_cuda_error_string.argtypes = [ctypes.c_int]
        want = ",".join(ptr_names) + ",|" + ",".join(dim_names) + ","
        have = layout().decode()
        if have != want:
            raise RuntimeError(
                f"{name}.cu argument layout differs from the host's:\n"
                f"  library: {have}\n  host:    {want}"
            )
        _libs[name] = lib
    return lib


def _dense_library():
    """``decide_dense``: the dense program's layout and the block shape."""
    return _library("decide_dense", DENSE_PTRS, DIMS + ROWS_DIMS, 4)


def _chunk_library():
    """``shard_chunk`` (``rule_chunk`` and ``set_chunk``)."""
    return _library("shard_chunk", CHUNK_PTRS,
                    DIMS + CHUNK_DIMS + ROWS_DIMS, 5)


def _tail_library():
    """``shard_tail``."""
    return _library("shard_tail", TAIL_PTRS, TAIL_DIMS, 2)


def _grouped_library():
    """``decide_grouped``."""
    return _library("decide_grouped", GROUPED_PTRS, DIMS + GROUPED_DIMS, 4)


def _sig_library():
    """``sig_decide``."""
    return _library("sig_decide", SIG_DECIDE_PTRS, SIG_DECIDE_DIMS, 3)


def _check_smem(name: str, lib, smem: int) -> None:
    """Raises when a launch needs more shared memory per block than the
    current device allows."""
    limit = lib.acs_max_smem_optin()
    if smem < 0 or smem > limit:
        raise ValueError(f"{name}: the tree needs {smem} bytes of shared "
                         f"memory per block, the device allows {limit}")


def _check_launch(name: str, lib, code: int) -> None:
    if code != 0:
        msg = ("argument count mismatch" if code < 0
               else lib.acs_cuda_error_string(code).decode())
        raise RuntimeError(f"{name} launch failed ({code}): {msg}")
    LAUNCHES[name] += 1


def _dims(c: dict, r: dict) -> dict[str, int]:
    """The dense program's shape ints; the tables may carry a leading
    group axis (``decide_grouped``'s stacked subtrees)."""
    S, KP, KR = c["rule_valid"].shape[-3:]
    return {
        "B": r["r_n_ra"].shape[0], "T": c["t_role"].shape[-1],
        "S": S, "KP": KP, "KR": KR,
        "KS": c["t_sub_ids"].shape[-1], "KA": c["t_act_ids"].shape[-1],
        "KE": c["t_ent_vals"].shape[-1], "KO": c["t_op_vals"].shape[-1],
        "KPR": c["t_prop_vals"].shape[-1],
        "NSUB": r["r_sub_ids"].shape[1], "NROLE": r["r_roles"].shape[1],
        "NACT": r["r_act_ids"].shape[1], "NR": r["r_ent_vals"].shape[1],
        "NP": r["r_prop_vals"].shape[1], "NOP": r["r_op_vals"].shape[1],
        "NRA": r["r_ra3"].shape[1], "NHR": r["r_acl_hr"].shape[1],
        "NACLE": r["r_acl_inst"].shape[1], "NACLI": r["r_acl_inst"].shape[2],
        "NHRR": r["r_hr_roles"].shape[1], "NRU": r["r_own_runs"].shape[1],
        "NWORDS": r["r_own_bits"].shape[1],
        "NRU_REL": r["r_rel_runs"].shape[1],
        "NWORDS_REL": r["r_rel_bits"].shape[1],
        "W": r["rgx_set"].shape[0], "E": r["rgx_set"].shape[1],
        "C": r["cond_true"].shape[0], "CSTRIDE": r["cond_true"].shape[1],
    }


def _sm_count(dev) -> int:
    """The SM count of ``dev`` (``HOST_SM_COUNT`` for the CPU)."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return HOST_SM_COUNT
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def rows_tiles(lib, d: dict, explain: bool, n_sm: int,
               mode: int = MODE_DENSE) -> dict:
    """The rows program's block shape ints (``ROWS_DIMS``) in ``mode``
    (``MODE_DENSE``, ``MODE_RULE`` or ``MODE_SET``) for the shapes ``d``,
    as ``lib`` (a library built from ``csrc/rows_core.cuh``,
    ``acs_rows_tile``) sizes them under ``ROWS_STAGE`` for ``n_sm`` SMs:
    ``PT`` policies per rule tile within ``rules`` bytes; ``RT`` rows per
    block, the fewest that keep the batch at most ``blocks_per_sm``
    blocks per SM, capped by ``rows`` and by the block's shared memory
    within ``block_bytes`` (a batch of fewer rows than that many blocks
    takes one row per block).  Cached per shapes and rule."""
    st = ROWS_STAGE
    stage = (n_sm, st["rows"], st["blocks_per_sm"], st["block_bytes"],
             st["rules"])
    vals = [d[k] for k in DIMS]
    key = (lib._name, mode, explain, stage, *vals)
    tile = _tiles.get(key)
    if tile is None:
        out = (ctypes.c_int32 * 2)()
        if lib.acs_rows_tile((ctypes.c_int32 * len(vals))(*vals), len(vals),
                             mode, int(explain),
                             (ctypes.c_int32 * 5)(*stage), out) != 0:
            raise RuntimeError("acs_rows_tile: argument count or mode "
                               "mismatch")
        if len(_tiles) >= 4096:
            _tiles.clear()
        tile = _tiles[key] = {"RT": out[0], "PT": out[1]}
    return tile


class LaunchArgs(NamedTuple):
    """One launch's C arguments: the output tensor, the pointer array
    (tables, rows, batch arrays, outputs, in ``acs_decide_dense_layout``
    order), the shape-int array, the shapes and the threads per block."""

    out: torch.Tensor
    ptrs: ctypes.Array
    dims: ctypes.Array
    shape: dict
    threads: int


def _c_ptrs(name: str, named: list, dev) -> list[int]:
    """Device pointers of (name, tensor or None) pairs after checking each
    tensor: on ``dev``, contiguous, int32 or bool (None passes a null)."""
    ptrs = []
    for arg, t in named:
        if t is None:
            ptrs.append(0)
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {dev}")
        if t.dtype not in (torch.int32, torch.bool, torch.uint8):
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}")
        ptrs.append(t.data_ptr())
    return ptrs


def _c_arrays(ptrs: list[int], dims: list[int]):
    return ((ctypes.c_int64 * len(ptrs))(*ptrs),
            (ctypes.c_int32 * len(dims))(*dims))


def _dense_named(c: dict, r: dict, name: str) -> tuple[dict, list]:
    """The dense program's shape ints and its (name, tensor) inputs after
    checking the shapes against the kernel's limits (``rule_orig_flat``
    null when the tables carry none)."""
    dims = _dims(c, r)
    for k, limit in _LIMITS.items():
        if dims[k] > limit:
            raise ValueError(f"{name}: {k}={dims[k]} exceeds the "
                             f"kernel's limit {limit}")
    named = [(k, c[k]) for k in TABLE_ARRAYS]
    named.append((ORIG_TABLE, c.get(ORIG_TABLE)))
    named += [(k, r[k]) for k in ROW_ARRAYS + BATCH_ARRAYS]
    return dims, named


def _outputs(n_rows: int, explain: bool, dev, zeroed: bool = False):
    """An int32 output [3 or 4, n_rows] and its (name, row) pairs, the
    fourth pointer null without explain."""
    alloc = torch.zeros if zeroed else torch.empty
    out = alloc((4 if explain else 3, n_rows), dtype=torch.int32,
                device=dev)
    return out, [(k, out[i] if i < out.shape[0] else None)
                 for i, k in enumerate(OUTPUTS)]


def pack_args(c: dict, r: dict, explain: bool = False,
              lib=None) -> LaunchArgs:
    """Check the tensors (one device, contiguous, int32 or bool, shapes
    within the kernel's limits), allocate the outputs ([4, B] with
    ``explain``) and pack the C arguments of one launch of the dense
    program (its shape ints, then the block shape of ``rows_tiles``, as
    ``lib``, by default ``decide_dense``'s library, sizes it)."""
    dev = r["r_n_ra"].device
    dims, named = _dense_named(c, r, "decide_dense")
    dims.update(rows_tiles(lib or _dense_library(), dims, explain,
                           _sm_count(dev)))
    out, out_named = _outputs(dims["B"], explain, dev)
    named += out_named
    ptrs, cdims = _c_arrays(_c_ptrs("decide_dense", named, dev),
                            [dims[k] for k in DIMS + ROWS_DIMS])
    return LaunchArgs(out=out, ptrs=ptrs, dims=cdims, shape=dims,
                      threads=ROWS_STAGE["threads"])


def _launch_dense(args: LaunchArgs, with_acl: bool, with_hr: bool,
                  with_rel: bool) -> torch.Tensor:
    """One launch of ``decide_dense`` (the explain variant when the output
    has four rows)."""
    dev = args.out.device
    lib = _dense_library()
    explain = int(args.out.shape[0] == 4)
    with torch.cuda.device(dev):
        _check_smem("decide_dense", lib, lib.acs_decide_dense_smem(
            ctypes.addressof(args.dims), len(args.dims), int(with_acl),
            explain))
        code = lib.acs_decide_dense(
            ctypes.addressof(args.ptrs), len(args.ptrs),
            ctypes.addressof(args.dims), len(args.dims), int(with_acl),
            int(with_hr), int(with_rel), explain, args.threads,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch("decide_dense", lib, code)
    return args.out


def decide_dense(c: dict, r: dict, with_acl: bool, with_hr: bool,
                 with_rel: bool, *, explain: bool = False) -> torch.Tensor:
    """Dense decisions for a whole batch -> int32 [3, B] (decision,
    cacheable, status; ``explain`` appends the provenance code).  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    if r["r_n_ra"].device.type == "cuda":
        return _launch_dense(pack_args(c, r, explain=explain), with_acl,
                             with_hr, with_rel)
    return torch.stack(decide_dense_ref(c, r, with_acl, with_hr, with_rel,
                                        explain=explain))


def decide_dense_occupancy(c: dict, r: dict, with_acl: bool, with_hr: bool,
                           with_rel: bool, *, explain: bool = False) -> int:
    """Resident ``decide_dense`` blocks per SM of the variant at one
    call's shapes (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    args = pack_args(c, r, explain=explain)
    with torch.cuda.device(r["r_n_ra"].device):
        return _dense_library().acs_decide_dense_occupancy(
            ctypes.addressof(args.dims), len(args.dims), int(with_acl),
            int(with_hr), int(with_rel), int(explain), args.threads)


# the shard programs' shape ints after the dense ones (csrc/decide_core.cuh
# ACS_CHUNK_DIMS, then ROWS_DIMS); their pointers are the dense list, whose
# outputs are passed null, then the merge buffer
CHUNK_DIMS = ("N_MODEL", "RANK", "OFFSET", "KR_TOTAL")
CHUNK_PTRS = DENSE_PTRS + ("merge",)
# the merge tail's tables (the rule-sharded mode) and argument order; KR
# is the rule stride of the explain code (the padded kr_total of the
# rule-sharded tables, the pod tables' KR)
TAIL_TABLES = ("pol_ca", "pol_effect", "pol_cacheable", "pol_n_rules",
               "set_ca")
TAIL_PTRS = ("merge",) + TAIL_TABLES + OUTPUTS
TAIL_DIMS = ("B", "S", "KP", "N_MODEL", "KR")
# the shard_tail block shapes the library has given, by library and mode
_tail_blocks: dict = {}


def pack_chunk_args(name: str, mode: int, c: dict, r: dict, offset: int,
                    kr_total: int, n_model: int, rank: int,
                    explain: bool = False, lib=None) -> LaunchArgs:
    """Check and pack one launch of a shard program (``rule_chunk`` mode
    ``MODE_RULE``, ``set_chunk`` mode ``MODE_SET``, the latter's merge
    row one column wider with ``explain``; the block shape of the mode
    from ``rows_tiles`` as ``lib``, by default ``shard_chunk``'s library,
    sizes it): allocates its merge rows [B, W] as the launch's ``out``."""
    dev = r["r_n_ra"].device
    dims, named = _dense_named(c, r, name)
    dims.update(N_MODEL=n_model, RANK=rank, OFFSET=offset, KR_TOTAL=kr_total)
    dims.update(rows_tiles(lib or _chunk_library(), dims, explain,
                           _sm_count(dev), mode))
    out = torch.empty((dims["B"], merge_width(mode, dims["S"], dims["KP"],
                                              n_model, explain)),
                      dtype=torch.int32, device=dev)
    named += [(k, None) for k in OUTPUTS] + [("merge", out)]
    ptrs, cdims = _c_arrays(_c_ptrs(name, named, dev),
                            [dims[k] for k in DIMS + CHUNK_DIMS + ROWS_DIMS])
    return LaunchArgs(out=out, ptrs=ptrs, dims=cdims, shape=dims,
                      threads=ROWS_STAGE["threads"])


def _launch_chunk(name: str, mode: int, args: LaunchArgs, with_acl: bool,
                  with_hr: bool, with_rel: bool, explain: bool = False
                  ) -> torch.Tensor:
    """One launch of ``csrc/shard_chunk.cu`` in ``mode``, counted under
    the wrapper's ``name`` (``rule_chunk`` or ``set_chunk``)."""
    dev = args.out.device
    lib = _chunk_library()
    with torch.cuda.device(dev):
        _check_smem(name, lib, lib.acs_shard_chunk_smem(
            ctypes.addressof(args.dims), len(args.dims), mode,
            int(with_acl), int(explain)))
        code = lib.acs_shard_chunk(
            ctypes.addressof(args.ptrs), len(args.ptrs),
            ctypes.addressof(args.dims), len(args.dims), mode, int(with_acl),
            int(with_hr), int(with_rel), int(explain), args.threads,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch(name, lib, code)
    return args.out


def rule_chunk(c: dict, r: dict, kr_offset: int, kr_total: int,
               n_model: int, rank: int, with_acl: bool, with_hr: bool,
               with_rel: bool) -> torch.Tensor:
    """Stages A-E of the rule-sharded program on one shard's compacted
    tables -> its int32 merge rows [B, W] (``ops/shard_ref``'s
    layout).  CUDA tensors launch ``csrc/shard_chunk.cu`` in its
    rule-chunk mode (the rows program, one block per ``RT`` rows); CPU
    tensors run the plain version."""
    if r["r_n_ra"].device.type != "cuda":
        return rule_chunk_ref(c, r, kr_offset, kr_total, n_model, rank,
                              with_acl, with_hr, with_rel)
    args = pack_chunk_args("rule_chunk", MODE_RULE, c, r, kr_offset,
                           kr_total, n_model, rank)
    return _launch_chunk("rule_chunk", MODE_RULE, args, with_acl, with_hr,
                         with_rel)


def set_chunk(c: dict, r: dict, s_offset: int, n_model: int, rank: int,
              with_acl: bool, with_hr: bool, with_rel: bool, *,
              explain: bool = False, t_live: int | None = None
              ) -> torch.Tensor:
    """Stages A-F of the pod-sharded program on one shard's set slots ->
    its int32 merge rows [B, W] (with ``explain`` the negated provenance
    key of the shard's last contributing set after the set key).
    ``t_live`` cuts the target table to the rows below it (a shard's
    table padded past its live rows with rows no index reaches: the
    result is the same).  CUDA tensors launch ``csrc/shard_chunk.cu`` in
    its set-chunk mode; CPU tensors run the plain version."""
    if r["r_n_ra"].device.type != "cuda":
        return set_chunk_ref(c, r, s_offset, n_model, rank, with_acl,
                             with_hr, with_rel, explain=explain,
                             t_live=t_live)
    c = live_rows(c, t_live)
    S, KP, KR = c["rule_valid"].shape
    args = pack_chunk_args("set_chunk", MODE_SET, c, r, s_offset, KR,
                           n_model, rank, explain)
    return _launch_chunk("set_chunk", MODE_SET, args, with_acl, with_hr,
                         with_rel, explain)


def _chunk_occupancy(mode: int, args: LaunchArgs, device, with_acl: bool,
                     with_hr: bool, with_rel: bool, explain: bool) -> int:
    with torch.cuda.device(device):
        return _chunk_library().acs_shard_chunk_occupancy(
            ctypes.addressof(args.dims), len(args.dims), mode,
            int(with_acl), int(with_hr), int(with_rel), int(explain),
            args.threads)


def rule_chunk_occupancy(c: dict, r: dict, kr_offset: int, kr_total: int,
                         n_model: int, rank: int, with_acl: bool,
                         with_hr: bool, with_rel: bool) -> int:
    """Resident ``rule_chunk`` blocks per SM of the variant at one call's
    shapes (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    args = pack_chunk_args("rule_chunk", MODE_RULE, c, r, kr_offset,
                           kr_total, n_model, rank)
    return _chunk_occupancy(MODE_RULE, args, r["r_n_ra"].device, with_acl,
                            with_hr, with_rel, False)


def set_chunk_occupancy(c: dict, r: dict, s_offset: int, n_model: int,
                        rank: int, with_acl: bool, with_hr: bool,
                        with_rel: bool, *, explain: bool = False,
                        t_live: int | None = None) -> int:
    """Resident ``set_chunk`` blocks per SM of the variant at one call's
    shapes (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    c = live_rows(c, t_live)
    args = pack_chunk_args("set_chunk", MODE_SET, c, r, s_offset,
                           c["rule_valid"].shape[2], n_model, rank, explain)
    return _chunk_occupancy(MODE_SET, args, r["r_n_ra"].device, with_acl,
                            with_hr, with_rel, explain)


class TailTables(dict):
    """The rule-sharded tail's tables (``TAIL_TABLES``, a dict of them as
    the plain version reads) with their checked device pointers packed
    once in ``TAIL_PTRS`` order (``ptrs``: the merge rows' and outputs'
    slots 0): ``pack_shard_tail`` fills in only the merge rows and the
    outputs.  ``RuleShardedKernel`` builds one per placement."""

    def __init__(self, tabs: dict):
        super().__init__((k, tabs[k]) for k in TAIL_TABLES)
        self.device = self["pol_ca"].device
        self.shape = tuple(self["pol_ca"].shape)
        self.ptrs = tuple(_c_ptrs("shard_tail", [(k, self.get(k))
                                                 for k in TAIL_PTRS],
                                  self.device))


# the tail's pointer slots: the merge rows, then the outputs
_TAIL_MERGE = TAIL_PTRS.index("merge")
_TAIL_OUT = TAIL_PTRS.index(OUTPUTS[0])
_NO_TABLES = (0,) * len(TAIL_PTRS)


def tail_block(lib, mode: int) -> dict:
    """The block shape ``lib`` (``csrc/shard_tail.cu``) launches ``mode``
    with, from ``acs_shard_tail_block``: ``threads`` per block and request
    ``rows`` per block (K8 a row per thread, K7 a row per warp)."""
    key = (lib._name, mode)
    shape = _tail_blocks.get(key)
    if shape is None:
        out = (ctypes.c_int32 * 2)()
        if lib.acs_shard_tail_block(mode, out) != 0:
            raise RuntimeError(f"acs_shard_tail_block: unknown mode {mode}")
        shape = _tail_blocks[key] = {"threads": out[0], "rows": out[1]}
    return shape


def pack_shard_tail(merge: torch.Tensor, n_model: int,
                    tabs: dict | None, explain: bool = False,
                    kr_stride: int = 0):
    """Check and pack one ``shard_tail`` launch: allocates the output ->
    (output [3, B] or [4, B], pointer array, shape-int array, mode).
    ``tabs`` a ``TailTables`` has its pointers packed already (a plain
    dict of ``TAIL_TABLES`` is packed here)."""
    dev = merge.device
    mode = MODE_SET if tabs is None else MODE_RULE
    if tabs is not None and not isinstance(tabs, TailTables):
        tabs = TailTables(tabs)
    S, KP = (0, 0) if tabs is None else tabs.shape
    B = merge.shape[0]
    if merge.dim() != 2 or merge.shape[1] != merge_width(mode, S, KP,
                                                         n_model, explain):
        raise ValueError("shard_tail: the merge rows do not match the "
                         "tables and the model-axis size")
    if (merge.dtype != torch.int32 or not merge.is_contiguous()
            or (tabs is not None and tabs.device != dev)):
        raise ValueError("shard_tail: the merge rows must be contiguous "
                         "int32 on the tables' device")
    out = torch.empty((4 if explain else 3, B), dtype=torch.int32,
                      device=dev)
    ptrs = list(_NO_TABLES if tabs is None else tabs.ptrs)
    ptrs[_TAIL_MERGE] = merge.data_ptr()
    base = out.data_ptr()
    for i in range(out.shape[0]):
        ptrs[_TAIL_OUT + i] = base + 4 * B * i
    return out, *_c_arrays(ptrs, [B, S, KP, n_model, kr_stride]), mode


def shard_tail(merge: torch.Tensor, n_model: int, tabs: dict | None = None,
               *, explain: bool = False, kr_stride: int = 0
               ) -> torch.Tensor:
    """The decisions from the merged merge rows -> int32 [3, B]
    (decision, cacheable, status; with ``explain`` the provenance code
    fourth, its rule positions in strides ``(KP, kr_stride)``).  ``tabs``
    (``TAIL_TABLES``, best a ``TailTables`` packed once) selects the
    rule-sharded tail, None the pod-sharded one.  CUDA tensors launch
    ``csrc/shard_tail.cu``; CPU tensors run the plain version."""
    if merge.device.type != "cuda":
        return shard_tail_ref(merge, n_model, tabs, explain=explain,
                              kr_stride=kr_stride)
    out, ptrs, cdims, mode = pack_shard_tail(merge, n_model, tabs, explain,
                                             kr_stride)
    lib = _tail_library()
    with torch.cuda.device(merge.device):
        code = lib.acs_shard_tail(
            ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(cdims),
            len(cdims), mode, int(explain), tail_block(lib, mode)["threads"],
            torch.cuda.current_stream(merge.device).cuda_stream,
        )
    _check_launch("shard_tail", lib, code)
    return out


def shard_tail_occupancy(merge: torch.Tensor, n_model: int,
                         tabs: dict | None = None, *, explain: bool = False,
                         kr_stride: int = 0) -> int:
    """Resident ``shard_tail`` blocks per SM of the variant one call (these
    arguments) launches, in the library's block shape
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    mode = MODE_SET if tabs is None else MODE_RULE
    lib = _tail_library()
    with torch.cuda.device(merge.device):
        return lib.acs_shard_tail_occupancy(
            mode, int(explain), tail_block(lib, mode)["threads"])


class SlotLayout(NamedTuple):
    """Rows sorted by group into ``[NSLOT, R]`` slots that each hold one
    group's rows (the signature path's layout, K3's and K4's): ``slot_g``
    int32 [NSLOT] each slot's group, ``grid2row`` int32 [NSLOT, R] each
    grid position's source row (a pad position reads a real row whose
    ``gp_orig`` is another position, and never stores), ``gp_orig`` int32
    [rows] each row's grid position."""

    slot_g: torch.Tensor
    grid2row: torch.Tensor
    gp_orig: torch.Tensor


def slot_layout(inv: np.ndarray, G: int, n_out: int, n_data: int = 1,
                take=None) -> tuple:
    """The slot layout of rows ``inv`` (each row's group, of ``G``) as
    numpy int32 arrays from ``take(shape)`` (default ``np.empty``) ->
    (slot_g [ns_pad], grid2row [ns_pad * R], gp_orig [n_out], R, nslot,
    ns_pad).  R derives from the bucketed row and group counts only; the
    slot count pads to the half-pow2 bucket and to a multiple of
    ``n_data`` (each rank of a data axis takes an equal share)."""
    if take is None:
        def take(shape):
            return np.empty(shape, np.int32)
    B = inv.shape[0]
    gb = pow2_bucket(G, floor=1)
    R = min(4096, pow2_bucket(max(8, 2 * pow2_bucket(B) // gb), floor=8))
    # near-unique signature mixes would inflate the slot grid by the R
    # floor; cap the padded rows at ~4x the bucketed batch
    R = min(R, max(8, pow2_bucket(4 * pow2_bucket(B) // gb, floor=8)))
    # a stable sort by group: numpy's radix sort where groups fit 16 bits
    row_order = np.argsort(inv.astype(np.uint16) if G <= 1 << 16 else inv,
                           kind="stable")
    counts = np.bincount(inv, minlength=G)
    slots_per_g = -(-counts // R)
    slot_base = np.concatenate(([0], np.cumsum(slots_per_g)))
    nslot = int(slot_base[-1])
    ns_pad = half_pow2_bucket(nslot, floor=8)
    if ns_pad % n_data:
        ns_pad = -(-ns_pad // n_data) * n_data
    starts = np.concatenate(([0], np.cumsum(counts)))
    rk = np.arange(B) - starts[inv[row_order]]
    grid_pos = ((slot_base[inv[row_order]] + rk // R) * R
                + rk % R).astype(np.int64)
    slot_g = take((ns_pad,))
    slot_g.fill(0)
    slot_g[:nslot] = np.repeat(np.arange(G, dtype=np.int32), slots_per_g)
    grid2row = take((ns_pad * R,))
    grid2row.fill(0)
    grid2row[grid_pos] = row_order
    gp_orig = take((n_out,))
    gp_orig.fill(0)
    gp_orig[row_order] = grid_pos.astype(np.int32)
    return slot_g, grid2row, gp_orig, R, nslot, ns_pad


def grouped_layout(g_idx: np.ndarray, G: int, device) -> SlotLayout:
    """``decide_grouped``'s slot layout of every row of ``g_idx`` (each
    row's group, of ``G``) on ``device``: built in pinned host memory
    for a card and copied without waiting for the card (the host
    allocator keeps each buffer until its copy has run)."""
    g = np.asarray(g_idx, np.int64)
    pinned = torch.device(device).type == "cuda"
    host = []

    def take(shape):
        host.append(torch.empty(shape, dtype=torch.int32,
                                pin_memory=pinned))
        return host[-1].numpy()

    _, _, _, R, _, ns_pad = slot_layout(g, G, g.shape[0], take=take)
    slot_g, grid2row, gp_orig = (t.to(device, non_blocking=True)
                                 for t in host)
    return SlotLayout(slot_g, grid2row.view(ns_pad, R), gp_orig)


def _grouped_tiles(d: dict, explain: bool, nslot: int, R: int) -> dict:
    """``decide_grouped``'s block shape ints (``GROUPED_DIMS``) from the
    shapes and ``GROUPED_STAGE``."""
    st = GROUPED_STAGE
    T, S, KP, KR = d["T"], d["S"], d["KP"], d["KR"]
    per_row = T + S * KP * (4 if explain else 1) + 3 * S + 12
    RT = max(1, min(R, st["rows"], st["row_bytes"] // per_row))
    PT = max(1, min(KP, st["rules"] // (9 * KR)))
    return {"NSLOT": nslot, "R": R, "RT": RT, "PT": PT}


def pack_grouped(inv: dict, cs: dict, r: dict, layout: SlotLayout,
                 explain: bool = False) -> LaunchArgs:
    """Check and pack one ``decide_grouped`` launch: the dense program's
    arguments over the stacked tables, then the slot layout and the block
    shape ints; allocates the outputs ([4, B] with ``explain``)."""
    c = {**inv, **cs}
    dev = r["r_n_ra"].device
    dims, named = _dense_named(c, r, "decide_grouped")
    out, out_named = _outputs(dims["B"], explain, dev)
    named += out_named + list(zip(("slot_g", "grid2row", "gp_orig"),
                                  layout))
    nslot, R = layout.grid2row.shape
    if layout.slot_g.shape != (nslot,) or \
            layout.gp_orig.shape != (dims["B"],):
        raise ValueError("decide_grouped: the slot layout does not match "
                         "the rows")
    dims.update(_grouped_tiles(dims, explain, nslot, R))
    ptrs, cdims = _c_arrays(_c_ptrs("decide_grouped", named, dev),
                            [dims[k] for k in DIMS + GROUPED_DIMS])
    return LaunchArgs(out=out, ptrs=ptrs, dims=cdims, shape=dims,
                      threads=GROUPED_THREADS)


def _grouped_args(inv: dict, cs: dict, g_idx, r: dict,
                  explain: bool) -> tuple[LaunchArgs, SlotLayout]:
    """One ``decide_grouped`` launch packed for the card, and the slot
    layout of the host group array ``g_idx`` that it reads, built and
    uploaded (the caller holds it until the launch is enqueued)."""
    if isinstance(g_idx, torch.Tensor) and g_idx.device.type != "cpu":
        raise ValueError("decide_grouped: g_idx must lie on the host")
    g = np.asarray(g_idx)
    if g.dtype != np.int32 or g.shape != (r["r_n_ra"].shape[0],):
        raise ValueError("decide_grouped: g_idx must be int32 [B]")
    layout = grouped_layout(g, cs["t_role"].shape[0], r["r_n_ra"].device)
    return pack_grouped(inv, cs, r, layout, explain), layout


def decide_grouped(inv: dict, cs: dict, g_idx, r: dict, with_acl: bool,
                   with_hr: bool, with_rel: bool, *,
                   explain: bool = False) -> torch.Tensor:
    """The dense program per row against its own compacted subtree:
    ``inv`` the group-invariant tables, ``cs`` the varying tables stacked
    ``[G, ...]`` (with ``explain`` also ``rule_orig_flat``), ``g_idx``
    int32 [B] each row's group, on the host (numpy or a CPU tensor) ->
    int32 [3, B] ([4, B] with ``explain``).  CUDA tensors launch
    ``csrc/decide_grouped.cu`` over the rows' slot layout, which the
    wrapper builds from ``g_idx``; CPU tensors run the plain version."""
    dev = r["r_n_ra"].device
    if dev.type != "cuda":
        return decide_grouped_ref(inv, cs, torch.as_tensor(g_idx,
                                                           device=dev),
                                  r, with_acl, with_hr, with_rel,
                                  explain=explain)
    # the layout stays referenced until the launch is enqueued
    args, layout = _grouped_args(inv, cs, g_idx, r, explain)
    lib = _grouped_library()
    with torch.cuda.device(dev):
        _check_smem("decide_grouped", lib, lib.acs_decide_grouped_smem(
            ctypes.addressof(args.dims), len(args.dims), int(with_acl),
            int(explain), args.threads))
        code = lib.acs_decide_grouped(
            ctypes.addressof(args.ptrs), len(args.ptrs),
            ctypes.addressof(args.dims), len(args.dims), int(with_acl),
            int(with_hr), int(with_rel), int(explain), args.threads,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch("decide_grouped", lib, code)
    return args.out


def decide_grouped_occupancy(inv: dict, cs: dict, g_idx, r: dict,
                             with_acl: bool, with_hr: bool, with_rel: bool,
                             *, explain: bool = False) -> int:
    """Resident ``decide_grouped`` blocks per SM of the variant at one
    call's shapes (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    args, _ = _grouped_args(inv, cs, g_idx, r, explain)
    lib = _grouped_library()
    with torch.cuda.device(r["r_n_ra"].device):
        return lib.acs_decide_grouped_occupancy(
            ctypes.addressof(args.dims), len(args.dims), int(with_acl),
            int(with_hr), int(with_rel), int(explain), args.threads)


def _planes_plan(d: dict, with_hr: bool, with_rel: bool
                 ) -> tuple[dict, int]:
    """``sig_planes``'s carved allocation for the shapes ``d``: the
    variant's planes (a rule or policy plane padded to whole quads of
    positions) and the component records; cached per shapes."""
    key = ("sig_planes", with_hr, with_rel,
           *(d[k] for k in ("G", "T", "S", "KP", "KR", "KS", "NR", "NOP")))
    plan = _tiles.get(key)
    if plan is not None:
        return plan
    G, S, KP, KR = d["G"], d["S"], d["KP"], d["KR"]
    lead = {"rl": (G, S, KP, KR), "pl": (G, S, KP), "sl": (G, S)}
    width = {"sub_ids": d["KS"], "sub_vals": d["KS"], "collect": d["NR"],
             "op_hit": d["NOP"]}
    specs = []
    for k in plane_names(with_hr, with_rel):
        pre = {"rl": "rl", "pl": "pl", "pp": "pl", "sl": "sl",
               "ss": "sl", "mu": "sl"}[k[:2]]
        field = k.split("_", 1)[1]
        w = width.get(field)
        dtype = (np.int32 if field in ("role", "n_sub", "rs", "rel_idx",
                                       "sub_ids", "sub_vals") else np.bool_)
        n = math.prod(lead[pre])
        specs.append((k, lead[pre] + ((w,) if w is not None else ()), dtype,
                      -(-n // 4) * 4 * (1 if w is None else w)))
    specs.append(("comp", (G * d["T"] * SIG_COMP_WORDS,), np.int32, None))
    if len(_tiles) >= 4096:
        _tiles.clear()
    plan = _tiles[key] = carve_plan(specs)
    return plan


def pack_sig_planes(tabs: dict, inv: dict, pseudo: dict, with_hr: bool,
                    with_rel: bool):
    """Check and pack one ``sig_planes`` launch: carves the planes and the
    component records out of one device allocation (each region
    ``CARVE_ALIGN``-aligned, a rule or policy plane padded to whole quads
    of positions, which the kernel's vector stores take) -> (planes dict
    of views, the allocation, pointer array, shape-int array, threads per
    block).  The caller keeps the allocation alive until the launch is
    enqueued."""
    dev = pseudo["r_ent_vals"].device
    G, S, KP, KR = tabs["rule_effect"].shape
    T = tabs["t_role"].shape[1]
    d = {
        "G": G, "T": T, "S": S, "KP": KP, "KR": KR,
        "KS": tabs["t_sub_ids"].shape[2], "KA": tabs["t_act_ids"].shape[2],
        "KE": tabs["t_ent_vals"].shape[2], "KO": tabs["t_op_vals"].shape[2],
        "KPR": tabs["t_prop_vals"].shape[2],
        "NACT": pseudo["r_act_ids"].shape[1],
        "NR": pseudo["r_ent_vals"].shape[1],
        "NP": pseudo["r_prop_vals"].shape[1],
        "NOP": pseudo["r_op_vals"].shape[1],
        "W": pseudo["rgx_set"].shape[1], "E": pseudo["rgx_set"].shape[2],
    }
    for k in ("NR", "NOP", "KE"):
        if d[k] > _LIMITS[k]:
            raise ValueError(f"sig_planes: {k}={d[k]} exceeds the kernel's "
                             f"limit {_LIMITS[k]}")
    plan, nbytes = _planes_plan(d, with_hr, with_rel)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = carve(buf, plan)
    del out["comp"]
    # the planes and records are this allocation's: their pointers by
    # offset; the inputs checked one by one
    base = buf.data_ptr()
    src = {**tabs, **inv, **pseudo}
    vals = _c_ptrs("sig_planes", [(k, src.get(k)) for k in SIG_PLANES_PTRS
                                  if k not in plan], dev)
    vals.reverse()
    ptrs, cdims = _c_arrays(
        [base + plan[k].offset if k in plan else vals.pop()
         for k in SIG_PLANES_PTRS], [d[k] for k in SIG_PLANES_DIMS])
    return out, buf, ptrs, cdims, SIG_PLANES_THREADS


def _sig_planes_library():
    """``sig_planes``."""
    return _library("sig_planes", SIG_PLANES_PTRS, SIG_PLANES_DIMS, 2)


def sig_planes(tabs: dict, inv: dict, pseudo: dict, with_hr: bool,
               with_rel: bool) -> dict:
    """Stage A per signature group, gathered to rule / policy / set
    planes: ``tabs`` the stacked varying tables ``[G, ...]``, ``inv`` the
    group-invariant tables, ``pseudo`` one pseudo-request per group
    (``rgx_set`` / ``pfx_neq`` ``[G, W, E]``) -> the planes ``[G, ...]``
    under ``prefilter_ref.plane_names(with_hr, with_rel)``, views of one
    allocation.  CUDA tensors launch ``csrc/sig_planes.cu`` (its component
    pass, then its planes pass); CPU tensors run the plain version."""
    dev = pseudo["r_ent_vals"].device
    if dev.type != "cuda":
        return sig_planes_ref(tabs, inv, pseudo, with_hr, with_rel)
    out, _, ptrs, cdims, threads = pack_sig_planes(tabs, inv, pseudo,
                                                   with_hr, with_rel)
    lib = _sig_planes_library()
    with torch.cuda.device(dev):
        code = lib.acs_sig_planes(
            ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(cdims),
            len(cdims), int(with_hr), int(with_rel), threads,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch("sig_planes", lib, code)
    return out


def sig_planes_occupancy(tabs: dict, inv: dict, pseudo: dict, with_hr: bool,
                         with_rel: bool) -> int:
    """Resident blocks per SM of the variant's planes pass
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _sig_planes_library()
    with torch.cuda.device(pseudo["r_ent_vals"].device):
        return lib.acs_sig_planes_occupancy(int(with_hr), int(with_rel),
                                            SIG_PLANES_THREADS)


def sig_planes_floor(tabs: dict, inv: dict, pseudo: dict, with_hr: bool,
                     with_rel: bool) -> Callable[[], None]:
    """The launch floor of one call's ``sig_planes`` launches: a function
    that launches an empty kernel over both launches' grids
    (``acs_sig_planes_floor``), for timing only; it counts no launch."""
    lib = _sig_planes_library()
    _, _, _, cdims, threads = pack_sig_planes(tabs, inv, pseudo, with_hr,
                                              with_rel)
    stream = torch.cuda.current_stream(
        pseudo["r_ent_vals"].device).cuda_stream

    def floor():
        if lib.acs_sig_planes_floor(ctypes.addressof(cdims), len(cdims),
                                    threads, stream) != 0:
            raise RuntimeError("acs_sig_planes_floor failed")
    return floor


def pack_sig_decide(inv: dict, cs: dict, planes: dict, slot_g, mega_rows,
                    grid2row, gp_orig, schedule: tuple, needs_pairs: bool,
                    with_hr: bool, with_rel: bool, explain: bool = False):
    """Check and pack one ``sig_decide`` launch: allocates the zeroed
    output ([4, b_pad] with ``explain``) -> (output, pointer array,
    shape-int array)."""
    dev = mega_rows.device
    S, KP, KR = cs["rule_effect"].shape[1:]
    NSLOT, R = grid2row.shape
    widths = {}
    offsets = {}
    off = 0
    for name, w, _ in schedule:
        offsets[name] = off
        widths[name] = w
        off += w
    if off != mega_rows.shape[1]:
        raise ValueError("sig_decide: the schedule does not cover the rows")
    d = {
        "NSLOT": NSLOT, "R": R, "S": S, "KP": KP, "KR": KR,
        "KS": planes["rl_sub_ids"].shape[-1],
        "NR": planes["rl_collect"].shape[-1] if with_hr or with_rel else 0,
        "NOP": planes["rl_op_hit"].shape[-1] if with_hr else 0,
        "WROW": off, "NSUB": widths["r_sub_ids"],
        "NROLE": widths["r_roles"], "NACT": widths["r_act_ids"],
        "NRU": widths.get("r_own_runs", 0),
        "NWORDS": widths.get("r_own_bits", 0),
        "NRU_REL": widths.get("r_rel_runs", 0),
        "NWORDS_REL": widths.get("r_rel_bits", 0),
        "C": widths["cond_true"], "NEEDS_PAIRS": int(needs_pairs),
        "RB": max(1, min(R, SIG_STAGE["rows"])),
        "PT": max(1, min(KP, SIG_STAGE["rules"] // (10 * KR))),
    }
    for dim, col in SIG_ROW_OFFSETS:
        d[dim] = offsets.get(col, -1)
    out, out_named = _outputs(gp_orig.shape[0], explain, dev, zeroed=True)
    src = {**inv, **cs, **planes, "slot_g": slot_g, "mega_rows": mega_rows,
           "grid2row": grid2row, "gp_orig": gp_orig, **dict(out_named)}
    named = [(k, src.get(k)) for k in SIG_DECIDE_PTRS]
    ptrs, cdims = _c_arrays(_c_ptrs("sig_decide", named, dev),
                            [d[k] for k in SIG_DECIDE_DIMS])
    return out, ptrs, cdims


def sig_decide(inv: dict, cs: dict, planes: dict, slot_g, mega_rows,
               grid2row, gp_orig, n_rows: int, schedule: tuple,
               needs_pairs: bool, with_hr: bool, with_rel: bool, *,
               explain: bool = False) -> torch.Tensor:
    """Decisions of a packed, slot-laid-out batch on the signature path:
    ``slot_g`` int32 [NSLOT] each slot's group, ``mega_rows`` int32
    [b_pad, W] the packed rows (columns per ``schedule``: (name, width,
    tail) in packing order), ``grid2row`` int32 [NSLOT, R] each grid
    position's source row, ``gp_orig`` int32 [b_pad] each row's grid
    position -> int32 [3, b_pad] in request order, rows past ``n_rows``
    0; with ``explain`` [4, b_pad], the provenance code fourth (``cs``
    then carries the stacked ``rule_orig_flat``).  CUDA tensors launch
    ``csrc/sig_decide.cu``; CPU tensors run the plain version."""
    dev = mega_rows.device
    if dev.type != "cuda":
        return sig_decide_ref(inv, cs, planes, slot_g, mega_rows, grid2row,
                              gp_orig, n_rows, schedule, needs_pairs,
                              with_hr, with_rel, explain=explain)
    out, ptrs, cdims = pack_sig_decide(inv, cs, planes, slot_g, mega_rows,
                                       grid2row, gp_orig, schedule,
                                       needs_pairs, with_hr, with_rel,
                                       explain)
    lib = _sig_library()
    with torch.cuda.device(dev):
        _check_smem("sig_decide", lib, lib.acs_sig_decide_smem(
            ctypes.addressof(cdims), len(cdims), SIG_DECIDE_THREADS))
        code = lib.acs_sig_decide(
            ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(cdims),
            len(cdims), int(with_hr), int(with_rel), int(explain),
            SIG_DECIDE_THREADS, torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch("sig_decide", lib, code)
    return out


def sig_decide_occupancy(inv: dict, cs: dict, planes: dict, slot_g,
                         mega_rows, grid2row, gp_orig, n_rows: int,
                         schedule: tuple, needs_pairs: bool, with_hr: bool,
                         with_rel: bool, *, explain: bool = False) -> int:
    """Resident ``sig_decide`` blocks per SM of the variant at one call's
    shapes (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    _, ptrs, cdims = pack_sig_decide(inv, cs, planes, slot_g, mega_rows,
                                     grid2row, gp_orig, schedule,
                                     needs_pairs, with_hr, with_rel, explain)
    lib = _sig_library()
    with torch.cuda.device(mega_rows.device):
        return lib.acs_sig_decide_occupancy(
            ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(cdims),
            len(cdims), int(with_hr), int(with_rel), int(explain),
            SIG_DECIDE_THREADS)


# the argument order of csrc/wia_planes.cu: the tables, the packed rows,
# the regex matrices, the planes and the scratch of the compacted rows
WIA_PLANES_PTRS = WIA_TABLES + ("rows", "rgx_set", "pfx_neq", "planes",
                                "rows_c")
# the packed row's columns the kernel reads, by the offset dim naming them
WIA_ROW_OFFSETS = tuple(("O_" + k[2:].upper(), k) for k in WIA_ROWS)
WIA_PLANES_DIMS = ("N", "T", "KA", "KE", "KO", "KPR", "NACT", "NR", "NP",
                   "NOP", "W", "E", "WROW") + tuple(
                       o for o, _ in WIA_ROW_OFFSETS) + ("TT", "RB")
# threads per wia_planes block, and how it sizes its blocks
# (``wia_tiles``): at most ``targets`` target rows per tile (a power of
# two) within ``block_bytes`` of shared memory, at most ``rows`` rows per
# block, the fewest that keep the grid within ``blocks_per_sm`` blocks per
# SM
WIA_THREADS = 256
WIA_STAGE = {"targets": 1024, "rows": 64, "blocks_per_sm": 2,
             "block_bytes": 48 * 1024}


def _wia_library():
    """``wia_planes``."""
    return _library("wia_planes", WIA_PLANES_PTRS, WIA_PLANES_DIMS, 0)


# the sources of the single-device serving path (K1-K5)
SERVING_SOURCES = ("decide_dense", "sig_planes", "sig_decide",
                   "decide_grouped", "wia_planes")


def load_libraries() -> None:
    """Load the kernel libraries of the single-device serving path
    (``SERVING_SOURCES``), building the stale ones first with one nvcc
    each, all at once; raises where one fails to build or load."""
    from . import cuda_build

    cuda_build.build(SERVING_SOURCES)
    for loader in (_dense_library, _sig_planes_library, _sig_library,
                   _grouped_library, _wia_library):
        loader()


def wia_tiles(lib, d: dict, n_sm: int) -> dict:
    """``wia_planes``'s block shape (``TT`` target rows per tile, ``RB``
    rows per block) for the shapes ``d`` on ``n_sm`` SMs, as ``lib``
    (``acs_wia_planes_tile``) sizes it under ``WIA_STAGE``, and the ints
    of a compacted row (``row_ints``); cached per shapes and stage."""
    st = WIA_STAGE
    stage = (st["targets"], st["rows"], st["blocks_per_sm"],
             st["block_bytes"])
    vals = [d.get(k, 0) for k in WIA_PLANES_DIMS]
    key = (lib._name, n_sm, stage, *vals)
    tile = _tiles.get(key)
    if tile is None:
        out = (ctypes.c_int32 * 3)()
        if lib.acs_wia_planes_tile((ctypes.c_int32 * len(vals))(*vals),
                                   len(vals), n_sm,
                                   (ctypes.c_int32 * 4)(*stage), out) != 0:
            raise RuntimeError("acs_wia_planes_tile: argument count "
                               "mismatch or no tile fits")
        if len(_tiles) >= 4096:
            _tiles.clear()
        tile = _tiles[key] = {"TT": out[0], "RB": out[1],
                              "row_ints": out[2]}
    return tile


def pack_wia_planes(tables: dict, rows, schedule: tuple, rgx_set, pfx_neq,
                    *, lib=None):
    """Check and pack one ``wia_planes`` launch: sizes the blocks with
    ``lib`` (the CUDA library unless given: the tests pass their g++-built
    one) and carves the planes and the compacted rows' scratch out of one
    allocation -> (planes, a view that keeps the allocation alive, pointer
    array, shape-int array, threads per block)."""
    dev = rows.device
    offsets, widths = {}, {}
    off = 0
    for name, w, _ in schedule:
        offsets[name], widths[name] = off, w
        off += w
    if off != rows.shape[1] or set(widths) != set(WIA_ROWS):
        raise ValueError("wia_planes: the schedule does not cover the rows")
    T = tables["t_n_res"].shape[0]
    d = {
        "N": rows.shape[0], "T": T,
        "KA": tables["t_act_ids"].shape[1],
        "KE": tables["t_ent_vals"].shape[1],
        "KO": tables["t_op_vals"].shape[1],
        "KPR": tables["t_prop_vals"].shape[1],
        "NACT": widths["r_act_ids"], "NR": widths["r_ent_vals"],
        "NP": widths["r_prop_vals"], "NOP": widths["r_op_vals"],
        "W": rgx_set.shape[0], "E": rgx_set.shape[1], "WROW": off,
    }
    for dim, col in WIA_ROW_OFFSETS:
        d[dim] = offsets[col]
    for k in ("NR", "NOP", "KE"):
        if d[k] > _LIMITS[k]:
            raise ValueError(f"wia_planes: {k}={d[k]} exceeds the kernel's "
                             f"limit {_LIMITS[k]}")
    tile = wia_tiles(lib or _wia_library(), d, _sm_count(dev))
    d["TT"], d["RB"] = tile["TT"], tile["RB"]
    n = d["N"] * len(PLANE_KEYS) * T
    off = -(-n // CARVE_ALIGN) * CARVE_ALIGN
    buf = torch.empty(off + 4 * d["N"] * tile["row_ints"], dtype=torch.uint8,
                      device=dev)
    out = buf[:n].view(torch.bool).view(d["N"], len(PLANE_KEYS), T)
    src = {**tables, "rows": rows, "rgx_set": rgx_set, "pfx_neq": pfx_neq}
    vals = _c_ptrs("wia_planes", [(k, src[k]) for k in WIA_PLANES_PTRS[:-2]],
                   dev)
    ptrs, cdims = _c_arrays(vals + [buf.data_ptr(), buf.data_ptr() + off],
                            [d[k] for k in WIA_PLANES_DIMS])
    return out, ptrs, cdims, WIA_THREADS


def wia_planes(tables: dict, rows, schedule: tuple, rgx_set, pfx_neq
               ) -> torch.Tensor:
    """The whatIsAllowed planes of packed representative rows:
    ``tables`` the ``reverse_ref.WIA_TABLES`` tensors, ``rows`` int32
    [N, WROW] packed per ``schedule`` ((name, width, tail), the columns
    of ``reverse_ref.WIA_ROWS``), ``rgx_set`` / ``pfx_neq`` bool [W, E]
    -> bool [N, 7, T] in ``reverse_ref.PLANE_KEYS`` order.  CUDA tensors
    launch ``csrc/wia_planes.cu``; CPU tensors run the plain version."""
    dev = rows.device
    if dev.type != "cuda":
        return wia_planes_ref(tables, rows, schedule, rgx_set, pfx_neq)
    lib = _wia_library()
    out, ptrs, cdims, threads = pack_wia_planes(tables, rows, schedule,
                                                rgx_set, pfx_neq, lib=lib)
    with torch.cuda.device(dev):
        code = lib.acs_wia_planes(
            ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(cdims),
            len(cdims), threads, torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch("wia_planes", lib, code)
    return out


def wia_planes_occupancy(tables: dict, rows, schedule: tuple, rgx_set,
                         pfx_neq) -> int:
    """Resident ``wia_planes`` blocks per SM at one call's shapes
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _wia_library()
    _, _, cdims, threads = pack_wia_planes(tables, rows, schedule, rgx_set,
                                           pfx_neq, lib=lib)
    with torch.cuda.device(rows.device):
        return lib.acs_wia_planes_occupancy(ctypes.addressof(cdims),
                                            len(cdims), threads)


def wia_planes_floor(tables: dict, rows, schedule: tuple, rgx_set, pfx_neq
                     ) -> Callable[[], None]:
    """The launch floor of one call's ``wia_planes`` launch: a function
    that launches an empty kernel over the same grid and shared memory
    (``acs_wia_planes_floor``), for timing only; it counts no launch."""
    lib = _wia_library()
    _, _, cdims, threads = pack_wia_planes(tables, rows, schedule, rgx_set,
                                           pfx_neq, lib=lib)
    stream = torch.cuda.current_stream(rows.device).cuda_stream

    def floor():
        if lib.acs_wia_planes_floor(ctypes.addressof(cdims), len(cdims),
                                    threads, stream) != 0:
            raise RuntimeError("acs_wia_planes_floor failed")
    return floor


class Runner:
    """One kernel variant's launcher, what the port keeps in a
    ``shared_jits`` registry where the JAX package keeps a jitted
    callable, under the same key.  It names the wrapper (looked up in
    ``scope``, the calling module's globals, at each call) and binds the
    variant's flags, which follow the call's own positional arguments.
    The kernels take their shapes at run time: the libraries behind the
    wrappers are built and loaded once per process (``_libs``,
    ``cuda_build``) and the launch sizing is cached per shapes
    (``rows_tiles``), so a kernel object built over patched tables
    reuses its runners and adds no build and no load."""

    def __init__(self, scope: dict, name: str, *flags, **kw):
        self.scope = scope
        self.name = name
        self.flags = flags
        self.kw = kw

    def __call__(self, *args, **kw):
        return self.scope[self.name](*args, *self.flags, **self.kw, **kw)


def runner(registry: dict, shared: bool, key: tuple, scope: dict,
           name: str, *flags, **kw) -> Runner:
    """The runner under ``key``: taken from (and, when new, put into)
    ``registry`` when ``shared`` (``dynamic_policies``), else a new one."""
    run = registry.get(key) if shared else None
    if run is None:
        run = Runner(scope, name, *flags, **kw)
        if shared:
            registry[key] = run
    return run


class DecisionKernel:
    """Compiled-policy decision kernel: the policy tables live on
    ``device`` (``None`` = the CUDA device) and each batch is one call of
    ``decide_dense``.  ``explain=True`` adds the provenance code as a
    fourth output, its positions in ``explain_strides`` = (KP, KR) of the
    compiled tables (through ``rule_orig_flat`` when the tables carry
    it).

    ``dynamic_policies=True`` (the hot-update mode, ops/delta.py)
    registers the two runners (the ACL and no-ACL variants) in
    ``shared_jits`` under the JAX package's keys (``("dense", with_acl,
    with_hr, with_rel)``, ``"explain"`` appended in explain mode), so a
    kernel swapped in over patched tables of the same shapes reuses
    them (``Runner``)."""

    def __init__(self, compiled: CompiledPolicies, device=None,
                 dynamic_policies: bool = False,
                 shared_jits: dict | None = None,
                 explain: bool = False):
        if not compiled.supported:
            raise ValueError(
                f"policy tree unsupported by kernel: {compiled.unsupported_reason}"
            )
        self.compiled = compiled
        self.device = resolve_device(device)
        self.dynamic_policies = bool(dynamic_policies)
        self._shared = shared_jits if shared_jits is not None else {}
        self.explain = bool(explain)
        self.explain_strides = (compiled.KP, compiled.KR)
        # explain-off launches pass no keyword: their calls are unchanged
        explain_kw = {"explain": True} if explain else {}
        self.with_hr = tree_needs_hr(compiled.arrays)
        self.with_rel = tree_needs_rel(compiled.arrays)
        self._c = tables_from_numpy(compiled.arrays, self.device,
                                    keys=TABLE_ARRAYS,
                                    optional=(ORIG_TABLE,))
        tail = ("explain",) if explain else ()
        self._run_noacl, self._run_acl = (
            runner(self._shared, self.dynamic_policies,
                   ("dense", acl, self.with_hr, self.with_rel) + tail,
                   globals(), "decide_dense", acl, self.with_hr,
                   self.with_rel, **explain_kw)
            for acl in (False, True))

    def evaluate(self, batch: RequestBatch):
        """Returns (decision, cacheable, status) numpy arrays [B], and the
        provenance codes fourth in explain mode."""
        return self.evaluate_async(batch)()

    def evaluate_async(self, batch: RequestBatch):
        """Copy the batch to the device and launch WITHOUT waiting for the
        result; returns a zero-arg callable that materializes the
        (decision, cacheable, status) tuple.  The batch axis is padded to
        a power-of-two bucket (``lead_padding``).

        Only batches carrying ACL pairs take the kernel variant with the
        verifyACL create-path scan; the no-pair variant is exact for
        everything else.  Relation trees read the batch's relation-closure
        bitplanes (a batch encoded without a store carries empty-table
        planes: every relation check fails closed)."""
        with_acl = bool((np.asarray(batch.arrays["r_acl_ent"]) >= 0).any())
        b, r = batch_from_numpy(batch, self.device, keys=ROW_ARRAYS)
        run = self._run_acl if with_acl else self._run_noacl
        return readback(run(self._c, r), b)


def readback(out: torch.Tensor, b: int):
    """Start the copy of a kernel's int32 [n_out, B] output to the host
    and return the thunk that waits for it: (decision, cacheable, status,
    and in explain mode the provenance code) numpy [b] each.  On the card
    the copy goes to pinned memory behind a CUDA event."""
    n_out = out.shape[0]
    if out.device.type == "cpu":
        host = out.numpy()
        return lambda: tuple(host[i, :b] for i in range(n_out))
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))

    def materialize():
        done.synchronize()
        arr = host.numpy()
        return tuple(arr[i, :b] for i in range(n_out))

    return materialize
