"""Native host runtime: the C++ wire-batch encoder with ctypes bindings.

``NativeBatchEncoder`` parses serialized ``acstpu.Request`` wire bytes
(protobuf + JSON context payloads) in C++ and fills the kernel row arrays
directly: the serving path's replacement for the per-request Python
encode (``ops/encode.py``), bit-identical by construction and held to the
JAX package's encoder and to the port's Python encoder by
``tests/test_torch_native.py``.  The port's copy of the JAX package's
``native/`` package; the C++ source is host code and has no CUDA.

The shared library is built on first use with g++ into the port's
``_build/`` directory, its file name carrying a hash of the source (an
edited source builds anew; a stale library is never loaded).  Each process
builds into its own temporary file and renames it into place, so
concurrent builds race harmlessly.  A failed build or load raises with
g++'s stderr; nothing falls back to the Python encoder here (the caller
decides what serves).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops import encode as _pyenc
from ..ops.carry import pow2_bucket
from ..ops.compile import CompiledPolicies
from ..ops.encode import RequestBatch
from ..ops.interner import ABSENT
from ..ops.relation import empty_relation_tables, relation_bits_needed
from ..ops.staging import default_pool

SRC = Path(__file__).resolve().parent / "host_encoder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None

# ptrs order for acs_enc_batch -- must match OutArrays in host_encoder.cpp
_ARRAY_ORDER = [
    "r_sub_ids", "r_sub_vals", "r_roles", "r_act_ids", "r_act_vals",
    "r_ent_vals", "r_ent_e", "r_ent_valid",
    "r_inst_run", "r_inst_id", "r_inst_valid", "r_inst_present",
    "r_inst_has_owners",
    "r_inst_owner_ent", "r_inst_owner_inst",
    "r_prop_vals", "r_prop_sfx", "r_prop_run", "r_prop_tail",
    "r_op_vals", "r_op_present", "r_op_has_owners",
    "r_op_owner_ent", "r_op_owner_inst",
    "r_ra3", "r_ra2", "r_n_ra", "r_hr",
    "r_ctx_present", "r_n_entity_attrs", "r_has_props", "r_has_target",
    "r_acl_short", "r_acl_ent", "r_acl_inst", "r_acl_hr", "r_hr_roles",
    "r_subject_id",
]

# caps order for acs_enc_batch -- must match Caps in host_encoder.cpp
_CAPS_ORDER = [
    "NR", "NI", "NP", "NSUB", "NACT", "NOP", "NOWN", "NRA", "NHR",
    "NROLE", "NACLE", "NACLI", "NHRR",
]

_URN_ORDER = [
    "entity", "property", "operation", "resourceID", "role",
    "roleScopingEntity", "roleScopingInstance", "ownerEntity",
    "ownerInstance", "actionID", "create", "read", "modify", "delete",
    "aclIndicatoryEntity", "aclInstance",
]


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libacs_host-{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    """Compile the source into ``lib``; raises with g++'s stderr."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as err:
        raise RuntimeError(f"native encoder build failed: {err}") from err
    if proc.returncode != 0:
        raise RuntimeError(
            f"native encoder build failed (g++ exit {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.acs_enc_create.restype = ctypes.c_void_p
        lib.acs_enc_create.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.acs_enc_destroy.restype = None
        lib.acs_enc_destroy.argtypes = [ctypes.c_void_p]
        lib.acs_enc_n_strings.restype = ctypes.c_int32
        lib.acs_enc_n_strings.argtypes = [ctypes.c_void_p]
        lib.acs_enc_string.restype = ctypes.c_int32
        lib.acs_enc_string.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.acs_enc_batch.restype = ctypes.c_int32
        lib.acs_enc_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32),  # caps (13 ints) or None
        ]
        lib.acs_own_max_runs.restype = ctypes.c_int32
        lib.acs_own_max_runs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.acs_pack_owner_bits.restype = None
        # raw buffer pointers + dims; see host_encoder.cpp for the order
        lib.acs_pack_owner_bits.argtypes = (
            [ctypes.c_void_p] * 14
            + [ctypes.c_int32] * 6
            + [ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int32] * 2
            + [ctypes.c_void_p, ctypes.c_void_p]
        )
        lib.acs_enc_intern.restype = ctypes.c_int32
        lib.acs_enc_intern.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.acs_pack_relation_bits.restype = None
        # raw buffer pointers + dims; see host_encoder.cpp for the order
        lib.acs_pack_relation_bits.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int32] * 3
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int64]
            + [ctypes.c_int32] * 2
            + [ctypes.c_void_p, ctypes.c_void_p]
        )
        _lib = lib
        return _lib


class NativeBatchEncoder:
    """Wire-bytes -> RequestBatch using the C++ core.

    Constraints (the constructor raises otherwise):
    - the compiled tree must carry no host-assisted conditions (condition
      predicates are evaluated in the Python sandbox against rich request
      objects);
    - inputs are serialized ``acstpu.Request`` messages (or a
      ``BatchRequest`` split by the caller).
    """

    def __init__(self, compiled: CompiledPolicies):
        if compiled.conditions:
            raise RuntimeError(
                "native encoder does not cover host-assisted conditions"
            )
        lib = load()
        self.lib = lib
        self.compiled = compiled

        interner = compiled.interner
        urns = compiled.urns
        # intern URNs/vocab FIRST: these may append to the interner, and the
        # preload snapshot below must contain every referenced id
        urn_ids = np.array(
            [interner.intern(urns.get(name)) for name in _URN_ORDER], np.int32
        )
        # vocab tails use the reference's entity_name (after-last-colon
        # segment), matching the Python encoder's relevance check and the
        # compiled table's t_ent_tails
        tails = [_pyenc.urn_tail(v) for v in compiled.entity_vocab]
        vocab_tails = np.array(
            [interner.intern(t) for t in tails], np.int32
        )
        tails_ambiguous = len(set(tails)) != len(tails)
        strings = list(interner._strings)
        encoded = [s.encode() for s in strings]
        blob = b"".join(encoded)
        offs = np.zeros(len(strings) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offs[1:])

        self._handle = lib.acs_enc_create(
            blob,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(strings),
            urn_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            1 if tails_ambiguous else 0,
            vocab_tails.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(compiled.entity_vocab),
        )
        if not self._handle:
            raise RuntimeError("native interner preload mismatch")
        self._rgx = _pyenc._RegexCache(compiled.entity_vocab)
        # the C++ encoder mutates shared state (interner, caches) and
        # ctypes releases the GIL -- one batch at a time per encoder
        self._call_lock = threading.Lock()
        # stage-B owner-bit vocab: with HR-bearing targets the packed
        # bitplanes are computed natively (acs_pack_owner_bits,
        # bit-identical to ops/encode.pack_owner_bitplanes; fuzz-checked
        # by tests/test_torch_native.py)
        if _pyenc.owner_bits_needed(compiled):
            self._hrv_role = np.ascontiguousarray(
                np.asarray(compiled.arrays["hrv_role"]), dtype=np.int32
            )
            self._hrv_scope = np.ascontiguousarray(
                np.asarray(compiled.arrays["hrv_scope"]), dtype=np.int32
            )
        else:
            self._hrv_role = self._hrv_scope = None
        # ReBAC relation planes (ops/relation.py): with relation-bearing
        # targets the packed closure bitplanes are computed natively too
        # (acs_pack_relation_bits, bit-identical to
        # ops/relation.pack_relation_bitplanes; fuzz-checked); the flat
        # verdict tables arrive per batch via encode_wire, translated
        # into THIS encoder's id space (native_relation_tables)
        self._needs_rel = relation_bits_needed(compiled)
        # pooled staging (ops/staging.py): with ``reuse=True`` the row
        # arrays, masks, regex matrices and owner-bit buffers all recycle
        # through arenas keyed by their (shape, caps) bucket: a warm
        # caller allocates nothing per batch on this stage.  The batch
        # carries a release callable; callers fire it after materialize.
        self._pool = default_pool()
        self._arena: dict[tuple, list[dict]] = {}
        self._arena_lock = threading.Lock()
        self.arena_hits = 0
        self.arena_misses = 0

    # ------------------------------------------------------- staging arena

    def _acquire_rows(self, B: int, caps) -> tuple[tuple, dict]:
        caps_key = tuple(sorted((caps or _pyenc._CAPS_FLOOR).items()))
        key = (B, caps_key)
        with self._arena_lock:
            free = self._arena.get(key)
            if free:
                self.arena_hits += 1
                rows = free.pop()
            else:
                self.arena_misses += 1
                rows = None
        if rows is not None:
            return key, _pyenc.reset_row_arrays(rows)
        return key, _pyenc.alloc_row_arrays(B, caps)

    def _release_rows(self, key: tuple, rows: dict) -> None:
        with self._arena_lock:
            free = self._arena.setdefault(key, [])
            if len(free) < 8:
                free.append(rows)

    def arena_stats(self) -> dict:
        with self._arena_lock:
            return {
                "hits": self.arena_hits,
                "misses": self.arena_misses,
                "free_sets": sum(len(v) for v in self._arena.values()),
            }

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and getattr(self, "lib", None) is not None:
            self.lib.acs_enc_destroy(handle)

    def _string(self, idx: int) -> str:
        n = self.lib.acs_enc_string(self._handle, idx, None, 0)
        buf = ctypes.create_string_buffer(n)
        self.lib.acs_enc_string(self._handle, idx, buf, n)
        return buf.raw[:n].decode()

    def owner_bits_native(self, a: dict, B: int, take=None) -> dict:
        """Packed stage-B owner bitplanes via the C++ packer: the native
        replacement for ops/encode.pack_owner_bitplanes over the same raw
        row arrays (bit-identical; fuzz-checked).  ``take(shape, dtype)``
        supplies buffers (the staging arena in pooled mode); np.empty
        otherwise."""
        if take is None:
            take = np.empty
        if self._hrv_role is None:
            out_runs = take((B, 1), np.int32)
            out_bits = take((B, 1), np.int32)
            out_runs.fill(ABSENT)
            out_bits.fill(0)
            return {"r_own_runs": out_runs, "r_own_bits": out_bits}
        NI = a["r_inst_run"].shape[1]
        NOWN = a["r_inst_owner_ent"].shape[2]
        NOP = a["r_op_vals"].shape[1]
        NRA = a["r_ra3"].shape[1]
        NHR = a["r_hr"].shape[1]
        RV = self._hrv_role.shape[0]
        max_runs = self.lib.acs_own_max_runs(
            a["r_inst_run"].ctypes.data, a["r_inst_valid"].ctypes.data,
            B, NI,
        )
        nru = _pyenc._pow2_at_least(int(max_runs) if B else 1, 1)
        _, _, _, nwords = _pyenc.owner_bit_layout(RV, nru, NOP)
        out_runs = take((B, nru), np.int32)
        out_bits = take((B, nwords), np.int32)
        self.lib.acs_pack_owner_bits(
            a["r_inst_run"].ctypes.data, a["r_inst_valid"].ctypes.data,
            a["r_inst_present"].ctypes.data,
            a["r_inst_has_owners"].ctypes.data,
            a["r_inst_owner_ent"].ctypes.data,
            a["r_inst_owner_inst"].ctypes.data,
            a["r_op_vals"].ctypes.data, a["r_op_present"].ctypes.data,
            a["r_op_has_owners"].ctypes.data,
            a["r_op_owner_ent"].ctypes.data,
            a["r_op_owner_inst"].ctypes.data,
            a["r_ra3"].ctypes.data, a["r_ra2"].ctypes.data,
            a["r_hr"].ctypes.data,
            B, NI, NOWN, NOP, NRA, NHR,
            self._hrv_role.ctypes.data, self._hrv_scope.ctypes.data,
            RV, nru,
            out_runs.ctypes.data, out_bits.ctypes.data,
        )
        return {"r_own_runs": out_runs, "r_own_bits": out_bits}

    @property
    def needs_relation_bits(self) -> bool:
        return self._needs_rel

    def _intern(self, s: str) -> int:
        """Intern in the C++ id space; caller holds ``_call_lock``."""
        raw = s.encode()
        return int(self.lib.acs_enc_intern(self._handle, raw, len(raw)))

    def native_relation_tables(self, store):
        """The store's flat verdict tables translated into this encoder's
        id space (srv/relations.tables_for(space="native")): strings
        interned after the preload snapshot get DIFFERENT ids in the
        Python and C++ interners, so each space builds (and caches) its
        own table.  None for relation-free trees."""
        if not self._needs_rel:
            return None
        with self._call_lock:
            return store.tables_for(
                self.compiled, intern=self._intern, space="native"
            )

    def relation_bits_native(self, a: dict, B: int, tables=None,
                             take=None) -> dict:
        """Packed relation closure bitplanes via the C++ packer: the
        native replacement for ops/relation.pack_relation_bitplanes over
        the same raw row arrays (bit-identical; fuzz-checked).  A missing
        table behaves as an empty tuple set (fail-closed), matching the
        Python packer and the scalar oracle."""
        if take is None:
            take = np.empty
        if not self._needs_rel:
            out_runs = take((B, 1), np.int32)
            out_bits = take((B, 1), np.int32)
            out_runs.fill(ABSENT)
            out_bits.fill(0)
            return {"r_rel_runs": out_runs, "r_rel_bits": out_bits}
        relv = int(np.asarray(self.compiled.arrays["relv_path"]).shape[0])
        if tables is None:
            tables = empty_relation_tables(relv)
        NI = a["r_inst_run"].shape[1]
        NR = a["r_ent_vals"].shape[1]
        max_runs = self.lib.acs_own_max_runs(
            a["r_inst_run"].ctypes.data, a["r_inst_valid"].ctypes.data,
            B, NI,
        )
        nru = _pyenc._pow2_at_least(int(max_runs) if B else 1, 1)
        _, _, _, nwords = _pyenc.owner_bit_layout(relv, nru, 0)
        out_runs = take((B, nru), np.int32)
        out_bits = take((B, nwords), np.int32)
        obj_offs = np.ascontiguousarray(tables["obj_offs"], np.int64)
        obj_keys = np.ascontiguousarray(tables["obj_keys"], np.int64)
        pairs = np.ascontiguousarray(tables["pairs"], np.int64)
        self.lib.acs_pack_relation_bits(
            a["r_inst_run"].ctypes.data, a["r_inst_valid"].ctypes.data,
            a["r_ent_vals"].ctypes.data, a["r_inst_id"].ctypes.data,
            a["r_subject_id"].ctypes.data,
            B, NR, NI,
            obj_offs.ctypes.data, obj_keys.ctypes.data, pairs.ctypes.data,
            int(pairs.shape[0]),
            relv, nru,
            out_runs.ctypes.data, out_bits.ctypes.data,
        )
        return {"r_rel_runs": out_runs, "r_rel_bits": out_bits}

    def encode_wire(self, messages: list[bytes],
                    caps: dict[str, int] | None = None,
                    reuse: bool = False,
                    relation_tables: dict | None = None) -> RequestBatch:
        """Encode serialized acstpu.Request messages.

        ``caps`` overrides the per-request padding shapes (the floor
        defaults otherwise).  Rows that were ineligible ONLY because a
        cap overflowed come back flagged in ``batch.overcap``: the
        serving path re-encodes exactly those rows at the ceiling shapes
        (ops/encode._CAPS_CEIL) so deep-HR wire traffic stays native.

        ``reuse=True`` draws every buffer (row arrays, masks, regex
        matrices, owner bits) from the staging arenas and attaches a
        ``batch.staging`` release callable, which the caller fires once
        it has read the batch's results; the buffers then recycle.  The
        default allocates fresh (callers that hold batches indefinitely
        must not pin arena slots)."""
        B = len(messages)
        blob = b"".join(messages)
        pool = self._pool if reuse else None
        leases: list[np.ndarray] = []

        def take(shape, dtype):
            if pool is None:
                return np.empty(shape, dtype)
            buf = pool.acquire(shape, dtype)
            leases.append(buf)
            return buf

        offs = take((B + 1,), np.int64)
        offs[0] = 0
        np.cumsum([len(m) for m in messages], out=offs[1:])

        if reuse:
            rows_key, a = self._acquire_rows(B, caps)
        else:
            rows_key, a = None, _pyenc.alloc_row_arrays(B, caps)
        eligible = take((B,), np.uint8)
        eligible.fill(1)
        overcap = take((B,), np.uint8)
        overcap.fill(0)
        nr = (caps or _pyenc._CAPS_FLOOR)["NR"]
        batch_entities = take((max(B, 1) * nr,), np.int32)
        caps_arg = None
        if caps is not None:
            caps_arr = np.array(
                [caps[k] for k in _CAPS_ORDER], np.int32
            )
            caps_arg = caps_arr.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)
            )

        ptrs = (ctypes.c_void_p * (len(_ARRAY_ORDER) + 3))()
        for i, name in enumerate(_ARRAY_ORDER):
            ptrs[i] = a[name].ctypes.data
        ptrs[len(_ARRAY_ORDER)] = eligible.ctypes.data
        ptrs[len(_ARRAY_ORDER) + 1] = batch_entities.ctypes.data
        ptrs[len(_ARRAY_ORDER) + 2] = overcap.ctypes.data

        with self._call_lock:
            n_entities = self.lib.acs_enc_batch(
                self._handle,
                blob,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                B,
                ptrs,
                caps_arg,
            )
            if n_entities < 0:
                if reuse:
                    self._release_rows(rows_key, a)
                    pool.release_all(leases)
                raise ValueError("malformed wire batch")

            # regex matrices over distinct batch entities (host regex work
            # is per distinct entity value, same as the Python encoder);
            # the _string readbacks stay under the lock -- they touch the
            # same C++ interner a concurrent batch would be mutating.
            # Pooled mode allocates at the pow2 entity bucket the kernels
            # pad to anyway (zero-filled tail columns are what pad_cols
            # would add), so recycled matrices skip that copy too.
            W = max(len(self.compiled.entity_vocab), 1)
            E = max(int(n_entities), 1)
            if reuse:
                E = pow2_bucket(E)
            rgx_set = take((W, E), bool)
            rgx_set.fill(0)
            pfx_neq = take((W, E), bool)
            pfx_neq.fill(0)
            for e in range(int(n_entities)):
                value = self._string(int(batch_entities[e]))
                set_col, neq_col = self._rgx.lookup(value)
                if set_col:
                    rgx_set[:, e] = set_col
                    pfx_neq[:, e] = neq_col

        # stage-B owner bitplanes, packed natively (bit-identical to the
        # Python packer ops/encode.pack_owner_bitplanes: structural for
        # trees without HR targets, fuzz-checked with them)
        arrays = dict(a)  # the arena keeps its canonical row-array dict
        arrays.update(self.owner_bits_native(
            a, B, take=take if reuse else None
        ))
        # relation closure bitplanes (dummies for relation-free trees;
        # fail-closed empties when no store table was supplied)
        arrays.update(self.relation_bits_native(
            a, B, tables=relation_tables, take=take if reuse else None
        ))

        release = None
        if reuse:
            def release(_key=rows_key, _rows=a, _leases=leases):
                self._release_rows(_key, _rows)
                pool.release_all(_leases)

        C = len(self.compiled.conditions)  # always 0 (ctor guard)
        return RequestBatch(
            B=B,
            arrays=arrays,
            rgx_set=rgx_set,
            pfx_neq=pfx_neq,
            cond_true=np.zeros((C, B), bool),
            cond_abort=np.zeros((C, B), bool),
            cond_code=np.full((C, B), 200, np.int32),
            eligible=eligible.view(np.bool_),
            requests=[],
            overcap=overcap.view(np.bool_),
            staging=release,
        )
