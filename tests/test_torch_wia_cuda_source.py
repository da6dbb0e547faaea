"""The CUDA source of the whatIsAllowed planes kernel (K5), run on the CPU.

``ops/csrc/wia_planes.cu`` (with the shared ``decide_core.cuh``) is
compiled as C++ with g++ against the threaded stand-in for
``cuda_runtime.h`` of ``test_torch_cuda_source`` (one ``std::thread`` per
CUDA thread).  The port's ``ReverseQueryKernel(device="cpu")`` answers
batches through the plain version while every ``wia_planes`` call is
recorded; each recorded call is then packed by the port's own
``pack_wia_planes`` and replayed through the emulated kernel, whose planes
must equal the plain version's byte for byte, pad rows included.  This
checks the kernel's logic and argument layout; that nvcc accepts it for
``sm_90a``, and the timing, are checked on the card by ``chip_smoke.py``.
"""

import ctypes
import random

import numpy as np
import pytest
import torch

from access_control_srv_tpu.core import populate
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import delta as jdelta
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops import reverse as treverse
from access_control_srv_tpu_torch.ops import reverse_ref as treverse_ref

from .test_kernel_differential import grid_requests
from .test_prefilter import _stress_doc
from .test_sig_kernel import _sig_requests, _sig_tree
from .test_torch_cuda_source import build_emulated
from .test_torch_delta import patched_compile
from .test_torch_prefilter import engine_of, stress_requests
from .utils import fixture, make_engine


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_emulated("wia_planes", tmp_path_factory.mktemp("wia_emu"))
    lib.acs_wia_planes_layout.restype = ctypes.c_char_p
    lib.acs_wia_planes.restype = ctypes.c_int
    lib.acs_wia_planes.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib._name = "wia_planes_emu"
    for fn, (restype, argtypes) in tkernel._SIZING["wia_planes"].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def record(monkeypatch):
    """Wrap the kernel entry the reverse query calls; each call is
    recorded with (copies of) its arguments and its plain output."""
    calls = []
    orig = treverse.wia_planes

    def wrapped(tables, rows, schedule, rgx_set, pfx_neq):
        out = orig(tables, rows, schedule, rgx_set, pfx_neq)
        calls.append(((tables, rows.clone(), schedule, rgx_set.clone(),
                       pfx_neq.clone()), out))
        return out

    monkeypatch.setattr(treverse, "wia_planes", wrapped)
    return calls


def replay(lib, calls) -> int:
    """Every recorded call through the emulated kernel; -> rows checked."""
    n = 0
    for args, want in calls:
        got, ptrs, dims, threads = tkernel.pack_wia_planes(*args, lib=lib)
        got.view(torch.uint8).fill_(0xCD)
        code = lib.acs_wia_planes(
            ctypes.addressof(ptrs), len(ptrs), ctypes.addressof(dims),
            len(dims), threads, None)
        assert code == 0
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        n += got.shape[0]
    return n


def run(engine, requests):
    compiled = jcompile(engine.policy_sets, engine.urns)
    assert compiled.supported
    kern = treverse.ReverseQueryKernel(compiled, engine.policy_sets,
                                       device="cpu")
    kern.evaluate(jencode(requests, compiled))
    return compiled


def test_layout_matches_host(lib):
    have = lib.acs_wia_planes_layout().decode()
    assert have == (",".join(tkernel.WIA_PLANES_PTRS) + ",|"
                    + ",".join(tkernel.WIA_PLANES_DIMS) + ",")


def test_argument_count_mismatch_is_refused(lib):
    ptrs = (ctypes.c_int64 * 3)()
    dims = (ctypes.c_int32 * 3)()
    assert lib.acs_wia_planes(ctypes.addressof(ptrs), 3,
                              ctypes.addressof(dims), 3, 64, None) == -1


@pytest.mark.parametrize("name", [
    "basic_policies.yml", "policy_set_targets.yml", "acl_policies.yml",
    "props_single.yml", "props_multi_rules_entities.yml", "ops_multi.yml",
])
def test_fixture_trees(lib, monkeypatch, name):
    """Fixture trees with the grid traffic (property rows among them):
    the first batch misses the plane cache for every signature."""
    calls = record(monkeypatch)
    run(make_engine(name), grid_requests(n=24, seed=211))
    assert replay(lib, calls) >= 8


@pytest.mark.parametrize("name", ["basic_policies.yml",
                                  "props_multi_rules_entities.yml"])
def test_patched_bucketed_tables(lib, monkeypatch, name):
    """Tables from ``full_bucketed_compile`` and one ``apply_events``
    patch (pad target rows, pad set slots at their tree positions, the
    sentinel entity-vocab rows): every ``wia_planes`` call equals its
    plain version."""
    engine = make_engine(name)
    compiled, _ = patched_compile(engine, jdelta, seed=11)
    calls = record(monkeypatch)
    kern = treverse.ReverseQueryKernel(compiled, engine.policy_sets,
                                       device="cpu")
    kern.evaluate(jencode(grid_requests(n=24, seed=213), compiled))
    assert replay(lib, calls) >= 8


def test_regex_signature_trees(lib, monkeypatch):
    """Foreign-namespace entities (regex prefix resets, the sticky state
    after the last run against any run) and ordered multi-entity runs."""
    rng = random.Random(91)
    calls = record(monkeypatch)
    for _ in range(2):
        engine = engine_of(_sig_tree(rng))
        if jcompile(engine.policy_sets, engine.urns).supported:
            run(engine, _sig_requests(rng, 24))
    assert calls and replay(lib, calls) >= 8


def has_props_rows(calls) -> int:
    """Real rows with r_has_props set among the recorded calls."""
    n = 0
    for (_, rows, schedule, _, _), _ in calls:
        off = 0
        for name, w, _ in schedule:
            if name == "r_has_props":
                n += int((rows[:, off] != 0).sum())
            off += w
    return n


@pytest.mark.parametrize("name", ["props_single.yml",
                                  "props_multi_rules_entities.yml"])
def test_rows_with_properties(lib, monkeypatch, name):
    """Rows carrying request properties: their own signatures (the
    has-props bit flips the PERMIT property-fail) and maybe-mask bits."""
    calls = record(monkeypatch)
    run(make_engine(name), grid_requests(n=40, seed=5))
    assert has_props_rows(calls) > 0
    assert replay(lib, calls) >= 8


def test_stress_tree_and_multi_set(lib, monkeypatch):
    """A 1,200-rule stress tree (T spans two tiles of target rows)
    and a multi-set tree with property rules."""
    calls = record(monkeypatch)
    doc, entities, actions = _stress_doc(n_policies=10, per_policy=120)
    compiled = run(engine_of(doc), stress_requests(entities, actions, n=12))
    T = compiled.arrays["t_role"].shape[0]
    assert T > tkernel.WIA_STAGE["targets"]
    engine = make_engine()
    for name in ["basic_policies.yml", "policy_targets.yml",
                 "props_multi_rules.yml"]:
        populate(engine, fixture(name))
    run(engine, grid_requests(n=16, seed=97))
    assert len(calls) == 2 and replay(lib, calls) >= 16


# ------------------------------------- K5's tiling on seeded random tables


def random_wia_call(rng, N, T, KA=2, KE=2, KO=2, KPR=2, NACT=3, NR=4, NP=2,
                    NOP=3, W=4) -> tuple:
    """One ``wia_planes`` call's arguments at the given shapes, the
    target columns, packed rows and regex matrices drawn by ``rng`` in
    their valid ranges; row 0 has no valid entity run, row 1 carries
    request properties."""
    E = max(NR, 1)

    def ints(shape, lo, hi):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    tables = {
        "t_act_ids": ints((T, KA), -1, 2), "t_act_vals": ints((T, KA), 0, 2),
        "t_ent_vals": ints((T, KE), -1, 5), "t_ent_w": ints((T, KE), -1, W),
        "t_ent_tails": ints((T, KE), -1, 3), "t_op_vals": ints((T, KO), -1, 4),
        "t_prop_vals": ints((T, KPR), -1, 4),
        "t_prop_sfx": ints((T, KPR), -1, 3),
        "t_has_props": rng.random(T) < 0.4, "t_n_res": ints((T,), 0, 3),
    }
    cols = {
        "r_act_ids": ints((N, NACT), -1, 2), "r_act_vals": ints((N, NACT), 0, 2),
        "r_ent_vals": ints((N, NR), -1, 5), "r_ent_e": ints((N, NR), 0, E),
        "r_ent_valid": ints((N, NR), 0, 2), "r_prop_vals": ints((N, NP), -1, 4),
        "r_prop_sfx": ints((N, NP), -1, 3), "r_prop_run": ints((N, NP), -1, NR),
        "r_prop_tail": ints((N, NP), -1, 3), "r_op_vals": ints((N, NOP), -1, 4),
        "r_has_props": ints((N,), 0, 2),
    }
    cols["r_ent_valid"][0] = 0
    cols["r_has_props"][1] = 1
    schedule = tuple((k, int(np.prod(cols[k].shape[1:])),
                      tuple(cols[k].shape[1:])) for k in treverse_ref.WIA_ROWS)
    rows = np.concatenate([cols[k].reshape(N, -1) for k in treverse_ref.WIA_ROWS],
                          axis=1)
    return ({k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in tables.items()},
            torch.from_numpy(np.ascontiguousarray(rows)), schedule,
            torch.from_numpy(rng.random((W, E)) < 0.3),
            torch.from_numpy(rng.random((W, E)) < 0.3))


def stage(monkeypatch, targets: int, rows: int, block_bytes=48 * 1024):
    """Tiles of at most ``targets`` target rows and ``rows`` rows, blocks
    of one warp, sized for one SM (so the rows per block reach their
    cap)."""
    monkeypatch.setitem(tkernel.WIA_STAGE, "targets", targets)
    monkeypatch.setitem(tkernel.WIA_STAGE, "rows", rows)
    monkeypatch.setitem(tkernel.WIA_STAGE, "block_bytes", block_bytes)
    monkeypatch.setattr(tkernel, "WIA_THREADS", 32)
    monkeypatch.setattr(tkernel, "HOST_SM_COUNT", 1)


# (N, T, target rows per tile, rows per block): T not a multiple of the
# tile or of 4 (plane rows that start unaligned, a last quad of one
# target) and N not of RB; whole tiles and aligned plane rows with a
# partial row block; a tile of 4 over 5 targets; tiles of 128 over 130
WIA_SHAPES = [(5, 37, 8, 3), (7, 64, 16, 4), (3, 5, 4, 8), (9, 130, 128, 2)]


@pytest.mark.parametrize("shape", WIA_SHAPES)
def test_tiles(lib, monkeypatch, shape):
    """K5 on seeded random tables at shapes that reach its tile edges:
    the planes equal to the plain version's byte for byte, rows without
    a valid run and rows with properties among them."""
    N, T, TT, RB = shape
    stage(monkeypatch, TT, RB)
    rng = np.random.default_rng(sum(shape))
    args = random_wia_call(rng, N, T)
    want = treverse_ref.wia_planes_ref(*args)
    got, ptrs, dims, threads = tkernel.pack_wia_planes(*args, lib=lib)
    d = dict(zip(tkernel.WIA_PLANES_DIMS, dims))
    tiles = -(-T // TT)
    assert (d["TT"], d["RB"]) == (TT, min(RB, -(-N * tiles // 2)))
    got.view(torch.uint8).fill_(0xCD)
    assert lib.acs_wia_planes(ctypes.addressof(ptrs), len(ptrs),
                              ctypes.addressof(dims), len(dims), threads,
                              None) == 0
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # every plane takes both values somewhere in the draw
    for p in range(len(treverse_ref.PLANE_KEYS)):
        assert {0, 1} <= set(want[:, p].flatten().int().tolist()), p


def test_tile_shape_and_exports(lib, monkeypatch):
    """The library's tile: the largest power-of-two target rows within
    the stage's shared bytes (halved until the block fits, -1 when none
    does), the fewest rows per block within the blocks per SM; its launch
    floor over the same grid and its occupancy (the stand-in's SM: 2,048
    threads, 232,448 bytes)."""
    def smem(tt, rb):
        # KA 2, KE 2, KO 2: 10 ints and a flags word a target row; 4 + 2 NR
        # + NOP + 2 NACT = 21 ints of lists a row and two bitsets of one
        # word (W 4) per run slot; 16-byte aligned
        return -(-4 * (11 * tt + (21 + 2 * 4) * rb) // 16) * 16

    args = random_wia_call(np.random.default_rng(3), 6, 300)
    stage(monkeypatch, 1024, 8)
    _, _, dims, threads = tkernel.pack_wia_planes(*args, lib=lib)
    d = dict(zip(tkernel.WIA_PLANES_DIMS, dims))
    assert (d["TT"], d["RB"]) == (1024, 3)
    stage(monkeypatch, 1024, 8, block_bytes=smem(64, 8))
    _, _, dims, _ = tkernel.pack_wia_planes(*args, lib=lib)
    assert dict(zip(tkernel.WIA_PLANES_DIMS, dims))["TT"] == 64
    stage(monkeypatch, 1024, 8, block_bytes=64)
    with pytest.raises(RuntimeError, match="no tile fits"):
        tkernel.pack_wia_planes(*args, lib=lib)
    stage(monkeypatch, 1024, 8)
    _, _, dims, _ = tkernel.pack_wia_planes(*args, lib=lib)
    assert lib.acs_wia_planes_floor(ctypes.addressof(dims), len(dims),
                                    threads, None) == 0
    assert lib.acs_wia_planes_floor(ctypes.addressof(dims), len(dims), 48,
                                    None) == -1
    assert lib.acs_wia_planes_occupancy(
        ctypes.addressof(dims), len(dims), 256) == min(
            2048 // 256, 232448 // smem(1024, 3))
