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

import pytest
import torch

from access_control_srv_tpu.core import populate
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu_torch.ops import kernel as tkernel
from access_control_srv_tpu_torch.ops import reverse as treverse

from .test_kernel_differential import grid_requests
from .test_prefilter import _stress_doc
from .test_sig_kernel import _sig_requests, _sig_tree
from .test_torch_cuda_source import build_emulated
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
        got, ptrs, dims, threads = tkernel.pack_wia_planes(*args)
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
    """A 1,200-rule stress tree (T spans two tiles of a block's threads)
    and a multi-set tree with property rules."""
    calls = record(monkeypatch)
    doc, entities, actions = _stress_doc(n_policies=10, per_policy=120)
    compiled = run(engine_of(doc), stress_requests(entities, actions, n=12))
    T = compiled.arrays["t_role"].shape[0]
    assert T > 4 * tkernel.threads_for(T)
    engine = make_engine()
    for name in ["basic_policies.yml", "policy_targets.yml",
                 "props_multi_rules.yml"]:
        populate(engine, fixture(name))
    run(engine, grid_requests(n=16, seed=97))
    assert len(calls) == 2 and replay(lib, calls) >= 16
