#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``access_control_srv_tpu_torch`` (never JAX, never the JAX package)
through its main paths and checks every kernel on them against its plain
PyTorch version:

1. device: the card's name and power limit;
2. build: the seven CUDA sources (``decide_dense``, ``sig_planes``,
   ``sig_decide``, ``decide_grouped``, ``wia_planes``, ``shard_chunk``
   (the ``rule_chunk`` and ``set_chunk`` kernels), ``shard_tail``), one
   nvcc each, all started together; ptxas registers and spills per kernel
   instantiation, each explain-off instantiation beside its explain twin
   (with ``--parent-csrc DIR`` also held against the same kernels built
   from another tree's sources: equal registers and spills, except
   ``sig_decide``, ``decide_grouped``, ``decide_dense``, ``set_chunk``,
   ``rule_chunk``, ``shard_tail``, ``sig_planes`` (and its component
   pass) and ``wia_planes``, listed as changed by design);
3. dense kernel vs plain: ``decide_dense`` against ``kernel_ref`` on the
   card, exactly equal, on every supported fixture tree (the relation
   fixture without a store: fail-closed), the seed data and the 511-rule
   scoped tree, in all four with_acl x with_hr variants;
4. dense kernel vs the port's scalar oracle on a sample per tree;
5. the dense main path: ``HybridEvaluator(engine).is_allowed_batch`` on
   4096 mixed requests against the 511-rule tree (below ``MIN_RULES``, so
   the ``PrefilteredKernel`` delegates to ``decide_dense``), every response
   equal to ``engine.is_allowed``;
6. signature kernels vs plain: ``PrefilteredKernel`` on the card, every
   ``sig_planes`` / ``sig_decide`` / ``decide_grouped`` call held exactly
   against its plain version on the same device tensors: fixture trees
   forced onto the signature machinery, the 720-rule stress tree with and
   without HR scoping, conditions and aborts, ACL and property batches;
7. the signature main paths at full width, each with the launch counts
   set to 0 just before it and read just after: (a) the 100k-rule stress
   tree with ``bench_stress`` traffic, 16,384 rows (``sig_planes`` on the
   first batch, ``sig_decide`` on every batch); (b) the 100k-rule scoped
   tree with ``bench_stress_hr`` traffic, 8,192 rows (``sig_decide`` with
   HR); (c) tree (a) with a few ACL rows in 16,384 (``decide_grouped``).
   Every kernel call of the first batch is held against its plain
   version, and a 32-row sample of responses against ``engine.is_allowed``;
8. times: each kernel at its main path's shapes (CUDA events) beside its
   plain version and its bound (``sig_planes`` and ``wia_planes`` in the
   K2 / K5 report below; ``sig_decide`` and ``decide_grouped``:
   the median of 5 windows of 100 launches of arguments packed once, with
   their resident blocks per SM); the evaluators' steady-state
   decisions/s and stage split; the dense kernel's throughput at 2^18 /
   2^16 rows;
9. whatIsAllowed planes vs plain: every ``wia_planes`` call of
   ``ReverseQueryKernel.evaluate`` held exactly against its plain version
   on the fixture trees with grid traffic, the 1,000- and 10,000-rule
   stress trees, and the 100k-rule stress tree with 256 representative
   rows of ``bench_stress`` traffic;
10. the whatIsAllowed main path: ``HybridEvaluator.what_is_allowed_batch``
   on ``wia-large`` (1,000 rules, 2,048 ``bench_wia_large`` queries), one
   ``wia_planes`` launch on the first batch and none on warm ones, every
   response equal to ``engine.what_is_allowed``; warm queries/s and the
   stage split;
11. the lattice sweep: ``AuditSweepManager`` in direct mode over the
   128 x 128 x 1 lattice on the 10,000-rule tree in 4,096-cell chunks, a
   warm then a timed sweep (zero ``wia_planes`` launches), the bitmap held
   against ``engine.is_allowed`` on a 256-cell strided sample;
12. relation variants vs plain: every ``with_rel`` call of
   ``decide_dense``, ``sig_planes``, ``sig_decide`` and
   ``decide_grouped`` held exactly against its plain version: the JAX
   package's ``tests/test_relations.py`` shapes (three rewrite kinds,
   depths 1-6, plain / ACL / property rows, a ``skip_relation_bits``
   batch, no store) through ``DecisionKernel`` and a forced
   ``PrefilteredKernel``, and the 720-rule stress tree with relation-path
   subjects on three rules in four, unscoped and scoped (signature
   kernels unforced), with every with_acl x with_hr combination of the
   relation variants;
13. the ReBAC main path, the JAX package's ``rebac-serve``: 1,000,000
   tuples (100,000 documents behind depth-4 folder chains), batches of
   4,096 rows through ``HybridEvaluator.attach_relation_store`` and
   ``is_allowed_batch`` (the 2-rule tree: the dense relation variant),
   every first-batch response against ``engine.is_allowed``; warm
   decisions/s, the stage split, K1's relation variant beside the same
   program on ``skip_relation_bits`` planes; then tuple churn that flips
   a probe with no new build, no ``sig_planes`` launch and an unchanged
   compiled version; then the times of the relation variants at their
   shapes (``sig_planes``'s from the K2 / K5 report).

14. the sharded programs' kernels vs plain: every shard of a 4-way rule
   partition and set partition of the shard-scale tree (the JAX
   package's ``bench_shard_scale``: the seed data plus 8,000 stress rules,
   2,048 wide rows), the 100k stress tree (``KR_local`` 100) and every
   fixture tree through ``rule_chunk``, ``set_chunk`` and ``shard_tail``,
   each exactly equal to its plain version; the shards' merge rows merged
   with ``amin`` (what the MIN ``all_reduce`` computes) and the merged
   decisions equal to ``PrefilteredKernel``'s;
15. the multi-device main paths: four ranks on the one card over gloo
   (``parallel.launch_local``), ``HybridEvaluator`` with ``mesh`` (4, 1)
   (K6 on the 511-rule tree, K3 and, with ACL rows, K4 on the shard-scale
   tree), ``model_axis`` at (2, 2) and (1, 4) (K7) and ``pod_shards`` at
   (2, 2) and (1, 4) (K8), each with the counts set to 0 just before its
   first batch and read just after, and every kernel call of that batch
   held exactly against its plain version; every rank's responses equal
   to the single-device evaluator's, 32 sampled rows equal to the oracle;
   per layout decisions/s and launches, and each kernel's time, plain
   time and bound on the very arguments the batch gave it (these are the
   K6-K8 rows of the kernel table), with the collective times; then one
   rule flip through ``PodShardedKernel.patched``:
   one shard re-sliced, the decision changed, no library built; then the
   K6 (4, 1), K7 (1, 4) and K8 (1, 4) layouts once more with
   ``explain=True``, every rank's ``_rule_id`` / ``_explain`` equal to the
   single-device explain evaluator's;
16. NCCL at world size 1: the rule- and pod-sharded evaluators at (1, 1)
   and the merge rows' MIN ``all_reduce`` through NCCL on the card;
17. explain variants vs plain: every explain call of ``decide_dense``,
   ``sig_decide`` and ``decide_grouped`` exactly equal to its plain
   version (all four outputs) on every supported fixture tree, the
   511-rule scoped tree and the seed data (ACL / property and signature
   batches, ``DecisionKernel`` and a forced ``PrefilteredKernel``, whose
   codes must agree), the 720-rule stress trees with conditions and
   aborts and with HR, and phase 12's relation variants; sampled codes
   decoded to the oracle's ``_rule_id``; ``set_chunk`` and both
   ``shard_tail`` modes in explain mode on the shard-scale tree's 4-way
   partitions, the merged codes equal to the single device's;
18. the explain main path, the JAX package's ``explain-overhead``:
   ``HybridEvaluator(engine, explain=True).is_allowed_batch`` on 8
   batches of 4,096 ``bench_stress`` rows (numpy seed 7) against the
   20,000-rule tree, counts set to 0 before the first batch and read
   after it, every kernel call of that batch held against its plain
   version, every response against the oracle (decision, status,
   ``_rule_id``); warm decisions/s; ``PrefilteredKernel`` explain off
   against on (decisions/s, ``overhead_pct`` beside the JAX package's
   20% bar, reported and not gated) and ``sig_decide``'s time in both
   variants beside its bound and plain time; one 16,384-row batch with 16
   ACL rows through ``decide_grouped``'s explain variant.
19. the wire main path: ``HybridEvaluator.is_allowed_batch_wire`` on
   serialized ``acstpu.Request`` bytes (written here from
   ``proto/access_control.proto``'s field numbers, ``wire_bytes``; checked
   against protobuf's serialization when ``google.protobuf`` imports) at
   ``serve-20k`` (the JAX package's ``bench_serving_e2e``: the seed data
   plus 20,000 stress rules, 8,192 rows of ``_serving_batch_msg(wide=True)``
   at numpy seed 11), at (a) (phase 7's evaluator and 16,384 rows) and at
   ``scoped_511`` (phase 5's 4,096 rows, the dense path): the native
   encoder active, counts set to 0 before each first batch and read after
   it, every kernel call of it held against its plain version, every
   eligible row's (decision, cacheable, status) equal to
   ``is_allowed_batch`` on the same Request objects, 32 sampled rows equal
   to the oracle (8 at (a), whose rows phase 7 sampled); then a
   ``serve-20k`` batch with 16 deep-HR rows past the
   floor caps, all re-encoded at the ceiling and equal to the oracle.
   Warm decisions/s over 8 batches (fresh and pooled staging) and the
   stage split, beside ``is_allowed_batch``'s on the same traffic; the
   wire call returns arrays (response framing comes with the transport).
   The line before: ``g++ --version`` and whether ``google.protobuf``
   imports;
20. ``token-mix`` (the JAX ``bench_token_mix``): 8,192 rows over 512
   bare tokens on the 10,000-rule tree through ``prepare_batch``
   (``StaticIdentityClient`` behind ``CachingIdentityClient``,
   ``HRScopeProvider``), eligible share at least 99%, sampled responses
   equal to the oracle, decisions/s with the preparation in every pass and
   the stage split;
21. ``adapter-mixed-warm`` (the JAX ``bench_adapter_mixed_warm``): the
   10,000-rule cacheable tree plus 8 context-query rules, the stub
   adapter, 8,192 rows at numpy seed 23 behind a ``DecisionCache``: a cold
   pass, then warm passes whose hits equal the cold responses; the cache's
   counts, warm decisions/s of the hit rows and of the mixed traffic;
22. the gRPC main path, the JAX ``bench_serving_e2e`` through the port's
   own serving shell: a ``srv/worker.Worker`` on the card (the seed data
   through the store, 20,000 stress rules upserted into it,
   ``async_compile`` on, stage histograms on), a ``GrpcServer`` on
   ``127.0.0.1:0`` and a client over loopback.  The first
   ``IsAllowedBatch`` (8,192 rows, phase 19's traffic) with every kernel
   call held against its plain version, every row's decision, cacheable
   and status equal to ``is_allowed_batch`` on the same Request objects,
   32 rows to the oracle, ``native-wire`` counting every row; warm
   wire-to-wire decisions/s over 8 calls (beside phase 19's evaluator
   wire rate and this worker's), the stage breakdown and the
   collector's pauses in those calls; 64 concurrent unary callers in
   another process x 1,024 ``IsAllowed`` at the deployed 2 ms batcher
   window (``cfg/config.json``: round-trip p50 / p99, the rows each path
   served, every answer equal to the oracle, the oracle's rows/s), then
   the same calls against a second worker started with the shipped
   ``cfg/config_unary.json`` overlay (a 10 ms window: the same answers,
   a ``sig_decide`` launch from its batcher);
   ``IsAllowedStream`` (4 frames through ``DevicePipeline``, each equal to
   the batch call) and 4 concurrent batch callers (the single-caller
   bytes); ``WhatIsAllowedBatch`` / ``WhatIsAllowed`` (64 queries, every
   ``wia_planes`` call against its plain version, every answer equal to
   ``engine.what_is_allowed``); a ``RuleService/Update`` that flips a
   probe and back (time to visibility of the async full recompile, the
   probe equal to the oracle after each); ``Health``, ``Command
   health_check``, the restorecommerce ``IsAllowed``; every fallback
   site's error count, every ``hang-fallback-*`` count and every
   ``*-degraded`` count (the device path's refusals) 0.  Its first line:
   the ``grpc`` version the server runs on.
23. hot policy updates at ``scoped_511`` (K1 on patched tables, the
   prefilter threshold's fallback);
24. the cluster tier: ``parallel.cluster.LocalCluster`` with a port
   broker, two port replica processes on the card (``python -m
   access_control_srv_tpu_torch --device cuda``) and a port router in
   this process.  The journal is seeded once with ``serve-20k`` (phase
   22's documents) and both replicas boot by replaying it in parallel,
   loading the libraries phase 2 built (nothing under ``_build/``
   changes); each replica's spawn to ready and to first answer.  8 warm
   routed ``IsAllowedBatch`` calls of phase 22's rows, byte-equal to the
   same rows sent to replica 0 and 32 sampled rows equal to the oracle,
   both replicas serving, routed decisions/s beside phase 22's direct
   rate; a 16-ACL-row batch (K4); then through the router (each step
   sent once the router holds every replica eligible) a rule flip
   and back (patches) and a combining-algorithm change and back
   (fallbacks), each with its time to convergence (every replica on one
   new ``table_fingerprint`` and a probe sent to each showing it) and
   ``delta_stats`` moved alike on the replica that served the RPC and on
   the other (its ``PolicyReplicator``); replica 1 stopped and restarted
   (``restart_replica``), its time to serve again, its fingerprint and
   answers equal to replica 0's; then 64 ``WhatIsAllowedBatch`` queries
   (K5) and an ``audit_sweep`` Command of a 32 x 32 x 1 lattice through
   the router (a replica's batcher), equal to a direct-mode sweep here
   on phase 19's tree.  Each replica's launch counts (the Command
   ``kernel_launches``) are set to 0 before the first answers and read
   after the ACL batch, and again around the K5 traffic; its paths (the
   Command ``metrics``) show the kernel path and no oracle, every error
   count 0.  The whatIsAllowed traffic comes after the CRUD steps
   because a reverse query interns its strings into the live compile's
   interner, as in JAX, so a later patch on that replica alone would
   lower on another vocabulary (another fingerprint, the same
   decisions);
25. the mesh layouts behind the Worker: three worlds of four ranks on
   the card over gloo, every rank started through the entry point
   (``parallel.cluster.MeshWorld``: ``python -m
   access_control_srv_tpu_torch --device cuda`` with the
   ``cluster:distributed`` block; rank 0 serves gRPC, ranks 1-3 run the
   follower loop, ``srv/follower.py``), each loading its tree from the
   store's JSON (``database:snapshot_dir``): ``pod_shards: 4`` on
   ``serve-20k`` (K8), ``model_devices: 2, data_devices: 2`` on
   ``shard-scale`` (K7), ``data_devices: 4`` on ``scoped_511`` (K6).
   The worlds boot one after another, each stopped before the next
   boots, so no other rank shares the card or the host while a world
   is timed.  Per world: every rank's table
   fingerprint equal at boot; the launch counts and stage histograms
   set to 0, then the first ``IsAllowedBatch`` and warm calls (8 of
   phase 22's 8,192 rows on ``serve-20k``, 3 of 2,048 on the others),
   every answer byte-equal to the single-device port's (the same
   transport framing over a single-device evaluator in this process);
   decisions/s beside phase 22's direct rate, the stages, the launches
   summed over the ranks and each rank's collectives per batch, the
   follower channel's bytes and ms per batch.  On ``serve-20k`` also the
   1,024-row batch with 16 ACL rows, ``CRUD_RULE`` flipped and back
   through rank 0's ``RuleService`` (each a patch, its time until every
   rank holds one new fingerprint and a probe shows it), then 64
   ``WhatIsAllowedBatch`` queries (K5, rank 0 alone) equal to the
   single device's.  No file under ``_build/`` changes, every error,
   shed and degraded count is 0, every rank exits 0; 32 sampled rows of
   each world's first batch (and the ACL rows) equal to the oracle.

After phase 18 the K3 / K4 report: each at (a), (b), (c) and explain on
/ off at phase 18's shapes, through its wrapper (as every kernel is
timed) and of arguments packed once, beside its bound, the ratio, its
ptxas numbers and resident blocks per SM, and the time recorded for the
design before.  Then the K1 / K6 / K8 report, the rows program at
its main-path calls (K1 at ``scoped_511``'s 4,096 rows, rank 0's 512- and
8-row K6 launches at mesh (4,1), ``rebac-serve``'s ``with_rel`` launch,
``set_chunk`` on the shard-scale stress shard at pod (1,4) and (2,2),
rebuilt in this process), each call held against its plain version,
explain on and off where the cell has both, its bound (``set_chunk``'s
over the live rows) beside the yardstick of the design before, and the
wrapper's host steps.  Then the K7 / tail report in the same form:
``rule_chunk`` on the rule shard with the most target rows at
``model_axis`` (1,4) and (2,2), ``shard_tail`` in K7 mode on the MIN of
every rule shard's merge rows and in K8 mode on the MIN of every set
shard's (explain on and off), rebuilt in this process and merged on the
device, the tail beside its launch floor (an empty kernel over the same
grid).  Then the K2 / K5 report: ``sig_planes`` at (a), (b) and at
relation-720 in all four (with_hr, with_rel) variants, ``wia_planes`` at
100k, the lattice and wia-large, each call held against its plain
version, through the wrapper and packed once, beside its launch floor
(an empty kernel over the same grids: K2's two launches, K5's one), its
bound (K2's beside the yardstick of the count before: every stacked
table read), the wrapper's host packing, ptxas numbers, blocks per SM
and block shape.  With ``--parent-csrc DIR`` the reports also time the
kernels built from ``DIR`` (the parent tree's ``ops/csrc``, its
``ops/kernel.py`` beside it) on the same arguments, both ways in the
same windows.  ``--quick`` runs phases 1-2, 6-7 and 9-12, the K2 / K5
report and phases 19 and 22 only (no result lines).

Any mismatch or error exits non-zero.  The line before the last is the
kernel table as one JSON object (K1-K4 carry their ``with_rel`` variant's
launches and times beside their own; ``decide_dense``, ``sig_decide``,
``decide_grouped``, ``set_chunk`` and ``shard_tail`` (and its ``pod``
object) their ``explain`` variant's; ``decide_dense`` K6's;
``decide_dense``, ``sig_planes`` and ``sig_decide`` phase 19's launches
(``wire``) and phase 22's (``grpc``); ``sig_planes`` to ``wia_planes``
phase 24's, summed over the replicas (``cluster``), and K5-K8 phase
25's, summed over the ranks (``mesh_worker``); the
redesigned kernels their packed-once and parent times, ``sig_planes``
and ``wia_planes`` also their launch floor and blocks per SM); the last
line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero before
printing any result.  Run from the repository root::

    python3 chip_smoke.py
"""

from __future__ import annotations

import atexit
import ctypes
import gc
import json
import multiprocessing
import os
import pickle
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch
import yaml

from access_control_srv_tpu_torch.core import (
    AccessController,
    load_policy_sets,
    load_policy_sets_from_file,
    load_seed_files,
)
from access_control_srv_tpu_torch.models import Attribute, Request, Target, Urns
from access_control_srv_tpu_torch.ops import compile_policies, encode_requests
from access_control_srv_tpu_torch.ops import cuda_build
from access_control_srv_tpu_torch.ops import kernel as kmod
from access_control_srv_tpu_torch.ops import prefilter as pfmod
from access_control_srv_tpu_torch.ops import prefilter_ref
from access_control_srv_tpu_torch.ops import reverse as rmod
from access_control_srv_tpu_torch.ops import reverse_ref
from access_control_srv_tpu_torch.ops import kernel_ref, shard_ref
from access_control_srv_tpu_torch.ops.carry import batch_from_numpy, tables_from_numpy
from access_control_srv_tpu_torch.ops.encode import (
    _CAPS_FLOOR,
    RequestBatch,
    fits_floor,
    owner_bit_layout,
    request_needs,
)
from access_control_srv_tpu_torch.ops.kernel_ref import decide_dense_ref
from access_control_srv_tpu_torch.ops.lattice import LatticeSpec, load_bitmap
from access_control_srv_tpu_torch.ops.relation import pack_relation_bitplanes
from access_control_srv_tpu_torch.parallel import mesh as mmod
from access_control_srv_tpu_torch.parallel import pod_shard, rule_shard
from access_control_srv_tpu_torch.srv.audit_sweep import AuditSweepManager
from access_control_srv_tpu_torch.srv.cache import HRScopeProvider, SubjectCache
from access_control_srv_tpu_torch.srv.decision_cache import DecisionCache
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.explain import ExplainDecoder
from access_control_srv_tpu_torch.srv.identity import (
    CachingIdentityClient,
    StaticIdentityClient,
)
from access_control_srv_tpu_torch.srv.relations import RelationTupleStore

REPO = os.path.dirname(os.path.abspath(__file__))
URNS = Urns()

ORG = "urn:restorecommerce:acs:model:organization.Organization"
USER = "urn:restorecommerce:acs:model:user.User"
ADDR = "urn:restorecommerce:acs:model:address.Address"
LOC = "urn:restorecommerce:acs:model:location.Location"
WIDGET = "urn:restorecommerce:acs:model:widget.Widget"
BUCKET = "urn:restorecommerce:acs:model:bucket.Bucket"
PO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides"
DO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides"

SUBJECTS = ["ada", "ben", "gil", "dee", "eva", "kai", "zoe", "Alice"]
ROLES = ["member", "manager", "guest", "Admin", "SimpleUser", "supervisor"]
ENTITIES = [ORG, USER, ADDR, LOC, WIDGET, BUCKET]
ACTIONS = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"],
           URNS["execute"]]
PROPS = [ORG + "#name", ORG + "#secret_field", USER + "#name",
         USER + "#password", ADDR + "#street", LOC + "#address",
         LOC + "#id", LOC + "#description", ORG + "#id", ORG + "#description"]
OWNERS = ["Org1", "Org2", "Org3", "Org4", "SuperOrg1", "otherOrg"]
STRESS_ENTITIES = [
    f"urn:restorecommerce:acs:model:stress{k}.Stress{k}" for k in range(64)
]
STRESS_ROLES = [f"role-{k}" for k in range(97)]
DEC_CODE = {"INDETERMINATE": 0, "PERMIT": 1, "DENY": 2}

CSRC = "access_control_srv_tpu_torch/ops/csrc/"
KERNELS = ("decide_dense", "sig_planes", "sig_decide", "decide_grouped",
           "wia_planes", "rule_chunk", "set_chunk", "shard_tail")
# the source each kernel is built from (csrc/<source>.cu): rule_chunk and
# set_chunk are the two modes of one source
SOURCE = {**{name: name for name in KERNELS}, "rule_chunk": "shard_chunk",
          "set_chunk": "shard_chunk"}
SOURCES = tuple(dict.fromkeys(SOURCE.values()))
# the JAX program each kernel replaces (file:line)
REPLACES = {
    "decide_dense": "access_control_srv_tpu/ops/kernel.py:1015",
    "sig_planes": "access_control_srv_tpu/ops/prefilter.py:700",
    "sig_decide": "access_control_srv_tpu/ops/prefilter.py:475",
    "decide_grouped": "access_control_srv_tpu/ops/prefilter.py:341",
    "wia_planes": "access_control_srv_tpu/ops/reverse.py:97",
    "rule_chunk": "access_control_srv_tpu/parallel/rule_shard.py:146",
    "set_chunk": "access_control_srv_tpu/parallel/pod_shard.py:182",
    "shard_tail": "access_control_srv_tpu/parallel/rule_shard.py:192",
}
# the with_rel stage of each kernel in the JAX programs (file:line)
REPLACES_REL = {
    "decide_dense": "access_control_srv_tpu/ops/kernel.py:680",
    "sig_planes": "access_control_srv_tpu/ops/prefilter.py:755",
    "sig_decide": "access_control_srv_tpu/ops/prefilter.py:563",
    "decide_grouped": "access_control_srv_tpu/ops/prefilter.py:334",
}
# the rebac-serve tuple count (the JAX package's REBAC_TUPLES default)
REBAC_TUPLES = 1_000_000
# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the scalar (non-tensor
# core) float32 rate used for the kernel's int32 compare/logic operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
ITERS = 5
# the kernels the port redesigned (K3, K4; K1 / K6 decide_dense, K7
# rule_chunk and K8 set_chunk, the rows program; shard_tail; K2
# sig_planes, K5 wia_planes): timed through the wrapper as every kernel
# is, and with STEADY_WINDOWS windows of STEADY_ITERS launches of
# arguments packed once (time_steady), reported beside their bound, their
# ptxas numbers, their resident blocks per SM, the parent tree's kernels
# (--parent-csrc) and the times PERF.md records for the design before
# (OLD_MS)
REDESIGNED = ("sig_decide", "decide_grouped", "decide_dense", "set_chunk",
              "rule_chunk", "shard_tail", "sig_planes", "wia_planes")
STEADY_ITERS, STEADY_WINDOWS = 100, 5
# their times beside ``ms`` in the kernel table: packed once, and the
# parent tree's kernel through its wrapper and packed once
PACKED_KEYS = ("kernel_ms", "parent_ms", "parent_kernel_ms")
# and the plane kernels' (K2, K5) launch floor and resident blocks per SM
PLANES_KEYS = ("floor_ms", "blocks_per_sm")
OLD_MS = {
    ("sig_decide", "a"): "1.054-1.103",
    ("sig_decide", "b"): "0.589",
    ("decide_grouped", "c"): "2.509-2.563",
    ("sig_decide", "explain"): "0.118 / 0.182, explain off 0.090 / 0.163",
    ("decide_grouped", "explain"): "1.014 / 1.016, explain off 0.651 / "
                                   "0.689",
    ("decide_dense", "scoped_511"): "0.223-0.249",
    ("decide_dense", "K6 (4,1)"): "0.340-0.395 for both launches, the "
                                  "8-row one alone 0.254",
    ("decide_dense", "rebac-serve"): "0.099-0.117",
    ("decide_dense", "explain"): "explain K6 (4,1) 0.320 / 0.396 for both "
                                 "launches",
    ("set_chunk", "(1,4)"): "1.142-1.165",
    ("set_chunk", "(2,2)"): "0.657-0.662",
    ("set_chunk", "explain"): "1.128 / 1.169 at (1,4)",
    ("rule_chunk", "(1,4)"): "0.226-0.249",
    ("rule_chunk", "(2,2)"): "0.211-0.273",
    ("shard_tail", "K7(1,4)"): "0.068-0.077",
    ("shard_tail", "K7(2,2)"): "0.073",
    ("shard_tail", "K8(1,4)"): "0.052-0.077",
    ("shard_tail", "K8(2,2)"): "0.059",
    ("shard_tail", "explain"): "0.069-0.104 (K7 (1,4)), 0.050-0.089 (K8)",
    ("sig_planes", "(a)"): "0.260-0.765 through the wrapper",
    ("sig_planes", "(b)"): "0.400 through the wrapper",
    ("sig_planes", "relation-720"): "0.210-0.472 through the wrapper "
                                    "(with_rel)",
    ("wia_planes", "100k"): "0.533-0.551 through the wrapper",
    ("wia_planes", "wia-large"): "0.043-0.128 through the wrapper",
    ("wia_planes", "lattice"): "0.042-0.048 through the wrapper",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def clone(obj):
    """A deep copy of requests or documents: a pickle round trip, which
    copies the model's plain dataclasses as ``copy.deepcopy`` does,
    several times faster on large batches."""
    return pickle.loads(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL))


# -------------------------------------------------------------- policy trees


def stress_doc(n_rules: int, scoped: bool = False, cacheable: bool = False):
    """The synthetic stress tree as a nested ``policy_sets`` document:
    deny-overrides set of permit-overrides policies, role/entity/action-
    targeted rules with interleaved PERMIT/DENY (every third rule DENY).
    ``scoped=True`` adds a roleScopingEntity to every rule's role subject,
    ``cacheable=True`` marks every rule ``evaluation_cacheable``.  A copy
    of the JAX package's bench generator (bench_all._stress_doc with its
    default for ``flip_every``)."""
    n_policies = max(1, n_rules // 400)
    per_policy = n_rules // n_policies
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    policies = []
    rid = 0
    for p in range(n_policies):
        rules = []
        for q in range(per_policy):
            entity = STRESS_ENTITIES[(p * 31 + q) % len(STRESS_ENTITIES)]
            subjects = [{"id": URNS["role"], "value": f"role-{rid % 97}"}]
            if scoped:
                subjects.append({
                    "id": URNS["roleScopingEntity"],
                    "value": ORG,
                })
            effect = "PERMIT" if rid % 3 else "DENY"
            rules.append(
                {
                    "id": f"r{rid}",
                    "target": {
                        "subjects": subjects,
                        "resources": [{"id": URNS["entity"], "value": entity}],
                        "actions": [
                            {"id": URNS["actionID"],
                             "value": actions[rid % len(actions)]}
                        ],
                    },
                    "effect": effect,
                    "evaluation_cacheable": cacheable,
                }
            )
            rid += 1
        policies.append(
            {"id": f"p{p}", "combining_algorithm": PO, "rules": rules}
        )
    doc = {
        "policy_sets": [
            {"id": "stress", "combining_algorithm": DO, "policies": policies}
        ]
    }
    return doc


def engine_for(name: str) -> AccessController:
    engine = AccessController()
    if name == "scoped_511":
        sets = load_policy_sets(stress_doc(511, scoped=True))
    elif name == "seed_data":
        seed = os.path.join(REPO, "data", "seed_data")
        sets = load_seed_files(
            os.path.join(seed, "policy_sets.yaml"),
            os.path.join(seed, "policies.yaml"),
            os.path.join(seed, "rules.yaml"),
        )
    else:
        sets = load_policy_sets_from_file(
            os.path.join(REPO, "tests", "fixtures", name))
    for ps in sets:
        engine.update_policy_set(ps)
    return engine


def tree_names() -> list[str]:
    fixtures = sorted(
        n for n in os.listdir(os.path.join(REPO, "tests", "fixtures"))
        if n.endswith(".yml")
    )
    return fixtures + ["seed_data", "scoped_511"]


# ----------------------------------------------------------------- requests


def _listify(value) -> list:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def build_request(subject_id=None, subject_role=None,
                  role_scoping_entity=None, role_scoping_instance=None,
                  resource_type=None, resource_id=None,
                  resource_property=None, action_type=None,
                  owner_indicatory_entity=None, owner_instance=None,
                  acl_indicatory_entity=None, acl_instances=None,
                  multiple_acl_indicatory_entity=None, org_instances=None,
                  subject_instances=None, hierarchical_scopes=None) -> Request:
    """The canonical request/context shape the service receives (subject
    [role, subject-id]; (entity, resource-id, properties...) runs or
    operations; owners, ACLs, role associations and HR scopes in the
    context)."""
    subjects = [
        Attribute(id=URNS["role"], value=subject_role or "member"),
        Attribute(id=URNS["subjectID"], value=subject_id or ""),
    ]
    resources: list[Attribute] = []
    types = _listify(resource_type)
    ids = _listify(resource_id)
    props = _listify(resource_property)
    if action_type == URNS["execute"]:
        for operation_name in types:
            resources.append(Attribute(id=URNS["operation"], value=operation_name))
    else:
        for i, rtype in enumerate(types):
            resources.append(Attribute(id=URNS["entity"], value=rtype))
            resources.append(Attribute(
                id=URNS["resourceID"], value=ids[i] if i < len(ids) else ""))
            for prop in props:
                resources.append(Attribute(id=URNS["property"], value=prop))
    actions = [Attribute(id=URNS["actionID"], value=action_type or "")]

    acls: list[dict] = []
    if acl_indicatory_entity and acl_instances:
        acls = [{
            "id": URNS["aclIndicatoryEntity"], "value": acl_indicatory_entity,
            "attributes": [{"id": URNS["aclInstance"], "value": inst}
                           for inst in acl_instances],
        }]
    elif multiple_acl_indicatory_entity and org_instances and subject_instances:
        acls = [
            {"id": URNS["aclIndicatoryEntity"],
             "value": multiple_acl_indicatory_entity[0],
             "attributes": [{"id": URNS["aclInstance"], "value": inst}
                            for inst in org_instances]},
            {"id": URNS["aclIndicatoryEntity"],
             "value": multiple_acl_indicatory_entity[1],
             "attributes": [{"id": URNS["aclInstance"], "value": inst}
                            for inst in subject_instances]},
        ]
    owner_instances = _listify(owner_instance)
    ctx_resources: list[dict] = []
    for i, rid in enumerate(ids if action_type != URNS["execute"] else types):
        owners = []
        if owner_indicatory_entity and owner_instances:
            inst = owner_instances[min(i, len(owner_instances) - 1)]
            owners = [{
                "id": URNS["ownerIndicatoryEntity"],
                "value": owner_indicatory_entity,
                "attributes": [{"id": URNS["ownerInstance"], "value": inst}],
            }]
        ctx_resources.append({"id": rid, "meta": {"owners": owners, "acls": acls}})
    role_associations = []
    if subject_role and role_scoping_entity and role_scoping_instance:
        role_associations = [{
            "role": subject_role,
            "attributes": [{
                "id": URNS["roleScopingEntity"], "value": role_scoping_entity,
                "attributes": [{"id": URNS["roleScopingInstance"], "value": inst}
                               for inst in _listify(role_scoping_instance)],
            }],
        }]
    if hierarchical_scopes is None:
        hierarchical_scopes = [{
            "id": "SuperOrg1", "role": subject_role,
            "children": [{"id": "Org1", "children": [
                {"id": "Org2", "children": [{"id": "Org3"}]}]}],
        }] if role_scoping_entity and role_scoping_instance else []
    return Request(
        target=Target(subjects=subjects, resources=resources, actions=actions),
        context={
            "resources": ctx_resources,
            "subject": {
                "id": subject_id,
                "role_associations": role_associations,
                "hierarchical_scopes": hierarchical_scopes,
            },
        },
    )


def grid_requests(rng: random.Random, n: int, stress: bool = False,
                  acl: bool = True, props: bool = True) -> list[Request]:
    """A randomized sweep over the request option space: single and multi
    entity rows, properties (when ``props``), owners in and out of scope,
    ACL pairs (when ``acl``) and execute operations.  ``stress`` draws
    entities and roles from the stress tree's vocabulary."""
    entities = STRESS_ENTITIES if stress else ENTITIES
    roles = STRESS_ROLES if stress else ROLES
    actions = ACTIONS[:4] if stress else ACTIONS
    out = []
    for _ in range(n):
        action = rng.choice(actions)
        multi = rng.random() < 0.3 and action != URNS["execute"]
        if action == URNS["execute"]:
            rtype = rng.choice(["mutation.runPipeline", "mutation.other"])
            rid = rtype
        elif multi:
            rtype = rng.sample(entities, 2)
            rid = [f"id-{i}" for i in range(2)]
        else:
            rtype = rng.choice(entities)
            rid = "id-0"
        prop = None
        if not stress and rng.random() < 0.5 and action != URNS["execute"]:
            prop = rng.sample(PROPS, rng.randint(1, 2))
            if not props:
                prop = None
        owner = owner_ent = None
        if rng.random() < 0.7:
            owner_ent = ORG
            owner = ([rng.choice(OWNERS) for _ in range(2)] if multi
                     else rng.choice(OWNERS))
        subject = rng.choice(SUBJECTS)
        acl_kwargs = {}
        roll = rng.random() if acl else 1.0
        if roll < 0.2:
            acl_kwargs = dict(
                acl_indicatory_entity=rng.choice([ORG, USER]),
                acl_instances=rng.sample(OWNERS + SUBJECTS, rng.randint(1, 3)),
            )
        elif roll < 0.35:
            acl_kwargs = dict(
                multiple_acl_indicatory_entity=[ORG, USER],
                org_instances=rng.sample(OWNERS, rng.randint(1, 3)),
                subject_instances=rng.sample([subject] + SUBJECTS, 2),
            )
        out.append(build_request(
            subject_id=subject, subject_role=rng.choice(roles),
            role_scoping_entity=ORG, role_scoping_instance=rng.choice(OWNERS),
            resource_type=rtype, resource_id=rid, resource_property=prop,
            action_type=action, owner_indicatory_entity=owner_ent,
            owner_instance=owner, **acl_kwargs,
        ))
    return out


def odd_requests(rng: random.Random, stress: bool = False) -> list[Request]:
    """Rows the kernel cannot represent, served by the oracle: no target,
    an unresolved token subject, role associations without HR scopes, a
    subject list beyond the widest padding, and entity runs beyond the
    floor caps (kernel-eligible at the wider shape)."""
    entities = STRESS_ENTITIES if stress else ENTITIES
    roles = STRESS_ROLES if stress else ROLES
    out = [Request(target=None, context={"subject": {"id": "ada"}})]
    tok = build_request(subject_id="ada", subject_role=rng.choice(roles),
                        role_scoping_entity=ORG, role_scoping_instance="Org1",
                        resource_type=rng.choice(entities), resource_id="id-0",
                        action_type=URNS["read"])
    tok.context["subject"]["token"] = "opaque-token"
    out.append(tok)
    noscope = build_request(subject_id="ben", subject_role=rng.choice(roles),
                            role_scoping_entity=ORG,
                            role_scoping_instance="Org2",
                            resource_type=rng.choice(entities),
                            resource_id="id-0", action_type=URNS["modify"])
    del noscope.context["subject"]["hierarchical_scopes"]
    out.append(noscope)
    wide = build_request(subject_id="gil", subject_role=rng.choice(roles),
                         resource_type=rng.choice(entities),
                         resource_id="id-0", action_type=URNS["read"])
    wide.target.subjects += [Attribute(id=URNS["subjectID"], value=f"x{i}")
                             for i in range(40)]
    out.append(wide)
    deep = build_request(subject_id="dee", subject_role=rng.choice(roles),
                         role_scoping_entity=ORG, role_scoping_instance="Org1",
                         resource_type=rng.sample(entities, 6),
                         resource_id=[f"id-{i}" for i in range(6)],
                         action_type=URNS["read"],
                         owner_indicatory_entity=ORG, owner_instance="Org1")
    out.append(deep)
    return out


def bench_batch(compiled, base: int, total: int, stress: bool = False
                ) -> RequestBatch:
    """Encode ``base`` distinct requests, then tile to ``total`` rows at
    array level (the JAX package's bench.py shape: half the rows carry the
    super-admin role; ``stress`` draws the stress tree's vocabulary)."""
    entities = [ORG, USER, ADDR, LOC] if not stress else STRESS_ENTITIES
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    rng = np.random.default_rng(42)
    requests = []
    for i in range(base):
        if stress:
            role = f"role-{int(rng.integers(97))}"
        else:
            role = "superadministrator-r-id" if i % 2 == 0 else f"role-{i % 7}"
        entity = entities[int(rng.integers(len(entities)))]
        org = OWNERS[int(rng.integers(len(OWNERS)))]
        ras = [{"role": role, "attributes": []}]
        resources = []
        if stress:
            ras = [{"role": role, "attributes": [{
                "id": URNS["roleScopingEntity"], "value": ORG,
                "attributes": [{"id": URNS["roleScopingInstance"],
                                "value": org}]}]}]
            resources = [{"id": f"res-{i % 1024}", "meta": {"owners": [{
                "id": URNS["ownerIndicatoryEntity"], "value": ORG,
                "attributes": [{"id": URNS["ownerInstance"],
                                "value": OWNERS[int(rng.integers(4))]}]}]}}]
        requests.append(Request(
            target=Target(
                subjects=[
                    Attribute(id=URNS["role"], value=role),
                    Attribute(id=URNS["subjectID"], value=f"user-{i % 512}"),
                ],
                resources=[
                    Attribute(id=URNS["entity"], value=entity),
                    Attribute(id=URNS["resourceID"], value=f"res-{i % 1024}"),
                ],
                actions=[Attribute(
                    id=URNS["actionID"],
                    value=actions[int(rng.integers(len(actions)))])],
            ),
            context={
                "resources": resources,
                "subject": {
                    "id": f"user-{i % 512}",
                    "role_associations": ras,
                    "hierarchical_scopes": [{
                        "id": "SuperOrg1", "role": role,
                        "children": [{"id": "Org1", "children": [
                            {"id": "Org2"}]}]}] if stress else [],
                },
            },
        ))
    batch = encode_requests(requests, compiled)
    if not batch.eligible.all():
        raise AssertionError("bench requests must be kernel-eligible")
    reps = -(-total // base)
    arrays = {k: np.tile(v, (reps,) + (1,) * (v.ndim - 1))[:total]
              for k, v in batch.arrays.items()}
    return RequestBatch(
        B=total, arrays=arrays, rgx_set=batch.rgx_set, pfx_neq=batch.pfx_neq,
        cond_true=np.tile(batch.cond_true, (1, reps))[:, :total],
        cond_abort=np.tile(batch.cond_abort, (1, reps))[:, :total],
        cond_code=np.tile(batch.cond_code, (1, reps))[:, :total],
        eligible=np.ones((total,), bool),
    )


# ------------------------------------------------------------ measurements


def ptxas_entries(log: str) -> dict:
    """ptxas's report per kernel instantiation in an nvcc log: {kernel
    name with its template arguments (bools as 0/1, e.g.
    ``decide_dense_kernel<0,1,0,1>``): (registers, spill stores, spill
    loads)}."""
    out: dict = {}
    name = mangled = None
    own = False  # the properties line being read is the entry's own
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            own = m.group(1) == mangled
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.match(r"_Z\d+(\w+?_kernel)", mangled)
            args = re.findall(r"L([bi])(\d+)E", mangled)
            name = (base.group(1) if base else mangled) + (
                "<" + ",".join(v for _, v in args) + ">" if args else "")
            out[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and own:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def ptxas_report(csrc: str, out_dir: str) -> dict:
    """Every source of ``SOURCES`` in the directory ``csrc`` built with the
    port's nvcc flags into ``out_dir`` (``lib<source>.so``), one nvcc
    each, all started together -> {source: ptxas_entries}; for holding
    the instantiations against another tree's sources.  The host code is
    built with ``-fno-gnu-unique``: the instances of a variable template
    (``shard_chunk.cu``'s shared-memory opt-in records) are otherwise
    unique symbols, which the process shares with the port's library of
    the same source, so the other tree's kernels would skip their own
    opt-in."""
    procs = [(name, subprocess.Popen(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xcompiler",
         "-fno-gnu-unique", "-o",
         os.path.join(out_dir, f"lib{name}.so"),
         os.path.join(csrc, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in SOURCES]
    out = {}
    for name, proc in procs:
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc}/{name}.cu:\n{se}")
        out[name] = ptxas_entries(so + se)
    return out


# the instantiations phase 2 lists as changed by design (set_chunk_kernel
# and rule_chunk_kernel were shard_chunk_kernel<2, ...> and
# shard_chunk_kernel<1, ..., 0> in trees before them: shard_chunk.cu's
# two modes)
REDESIGNED_PTX = ("sig_decide_kernel", "decide_grouped_kernel",
                  "decide_dense_kernel", "set_chunk_kernel",
                  "rule_chunk_kernel", "shard_tail_kernel",
                  "sig_planes_kernel", "sig_planes_comp_kernel",
                  "wia_planes_kernel", "wia_rows_kernel")


def former_name(name: str) -> str:
    """An instantiation's name in a tree before the shard modes had
    kernels of their own: ``set_chunk_kernel<a,h,r,e>`` was
    ``shard_chunk_kernel<2,a,h,r,e>``, ``rule_chunk_kernel<a,h,r>``
    ``shard_chunk_kernel<1,a,h,r,0>``."""
    if name.startswith("set_chunk_kernel<"):
        return "shard_chunk_kernel<2," + name[len("set_chunk_kernel<"):]
    if name.startswith("rule_chunk_kernel<"):
        return ("shard_chunk_kernel<1," + name[len("rule_chunk_kernel<"):-1]
                + ",0>")
    return name


def explain_off_twin(name: str) -> str:
    """The name an instantiation had before the explain flag: the last
    template argument of an explain-capable kernel dropped."""
    base = name.split("<")[0]
    if base not in ("decide_dense_kernel", "decide_grouped_kernel",
                    "shard_chunk_kernel", "set_chunk_kernel",
                    "shard_tail_kernel", "sig_decide_kernel"):
        return name
    args = name[len(base) + 1:-1].split(",")
    return base + ("<" + ",".join(args[:-1]) + ">" if len(args) > 1 else "")


def phase_ptxas(other_csrc: str | None = None,
                other_dir: str | None = None) -> dict:
    """Phase 2's report: ptxas's registers and spills for every kernel
    instantiation this process built, each explain-on instantiation beside
    its explain-off twin.  With ``other_csrc`` (another tree's
    ``ops/csrc``, e.g. the parent commit's) those sources are built too,
    into ``other_dir``, and every instantiation is held against the same
    kernel there (explain-off ones against a tree from before the explain
    flag): equal registers and spills, except the kernels
    ``REDESIGNED_PTX`` lists as changed by design, which are printed
    beside their old numbers."""
    mine: dict = {}
    for name in SOURCES:
        mine.update(ptxas_entries(cuda_build.BUILD_LOG.get(name, "")))
    other: dict = {}
    if other_csrc:
        for entries in ptxas_report(other_csrc, other_dir).values():
            other.update(entries)
    if not mine:
        log("  ptxas: every library was already built; no report")
        return mine
    def explain_on(k: str) -> bool:
        return explain_off_twin(k) != k and k.endswith(",1>")

    for k in sorted(mine):
        if explain_on(k):
            continue
        regs, st, ld = mine[k]
        twin = k[:-2] + "1>" if explain_off_twin(k) != k else None
        on = mine.get(twin) if twin else None
        log(f"  ptxas {k}: {regs} registers, spill stores {st} B, loads "
            f"{ld} B" + (f"; explain on {twin}: {on[0]} registers, spill "
                         f"stores {on[1]} B, loads {on[2]} B" if on else ""))
    if other_csrc:
        same, changed, by_design = 0, [], []
        for k, v in sorted(mine.items()):
            if k.split("<")[0] in REDESIGNED_PTX:
                by_design.append((k, other.get(k, other.get(former_name(k))),
                                  v))
                continue
            # by name; a tree from before the explain flag has only the
            # explain-off twins
            old = other.get(k, other.get(explain_off_twin(k)))
            if old is None or (explain_on(k) and k not in other):
                continue
            if tuple(old) == tuple(v):
                same += 1
            else:
                changed.append((k, old, v))
        log(f"  ptxas against {other_csrc}: {same} instantiations with "
            f"equal registers and spills, {len(changed)} changed: "
            f"{changed}")
        for k, old, v in by_design:
            log(f"  ptxas {k} (changed by design): {v[0]} registers, "
                f"spills {v[1]} / {v[2]} B; before: " + (
                    f"{old[0]} registers, spills {old[1]} / {old[2]} B"
                    if old else "none"))
        moved = sorted({k.split("<")[0] for k, old, v in by_design
                        if old is None or tuple(old) != tuple(v)})
        kept = sum(k.split("<")[0] not in moved for k, _, _ in by_design)
        log(f"  ptxas: {kept} of {len(by_design)} instantiations listed as "
            f"changed by design keep the other tree's numbers (every one "
            f"of a kernel outside {moved})")
        if changed:
            raise AssertionError(f"phase 2: kernels outside "
                                 f"{REDESIGNED_PTX} changed: {changed}")
    return mine


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def device_inputs(compiled, batch, device):
    """(tables, real rows, batch tensors, (with_acl, with_hr, with_rel))
    on ``device`` as DecisionKernel carries them."""
    c = tables_from_numpy(compiled.arrays, device, keys=kmod.TABLE_ARRAYS)
    b, r = batch_from_numpy(batch, device, keys=kmod.ROW_ARRAYS)
    with_acl = bool((batch.arrays["r_acl_ent"] >= 0).any())
    return c, b, r, (with_acl, kmod.tree_needs_hr(compiled.arrays),
                     kmod.tree_needs_rel(compiled.arrays))


def time_ms(fn, iters: int = ITERS) -> float:
    """Mean milliseconds per call on the device (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


REL_TABLES = ("t_rel_idx", "t_rel_direct")
REL_ROWS = ("r_rel_runs", "r_rel_bits")


def passing_pairs(c: dict, r: dict, t_rows=None) -> int:
    """The (row, target) pairs whose subject and action tests pass: the
    only pairs whose stage-A fold a call needs (the plain version's own
    tests, a row chunk at a time), over the target rows ``t_rows`` (all
    when None)."""
    n = 0
    for rc in kernel_ref.row_chunks(c, r):
        ok = kernel_ref._subject_ok(c, rc) & kernel_ref._pairs_subset(
            c["t_act_ids"], c["t_act_vals"], rc["r_act_ids"],
            rc["r_act_vals"])
        n += int((ok if t_rows is None else ok[:, t_rows]).sum())
    return n


def bound_ms(c: dict, r: dict, with_rel: bool = False,
             every_pair: bool = False) -> tuple[float, str, int, int]:
    """The least time the card could take for one call: the larger of the
    bytes the kernel must move (every input once, outputs once) over the
    HBM rate and the int32 compare/logic operations it needs at these
    shapes over the scalar peak: per (row, target) pair the subject and
    action test, the rest of the stage-A fold only for the pairs that
    pass it (``passing_pairs``; ``every_pair``: for every pair, the
    yardstick of the design before the rows program and the only count
    for stacked group tables), per row every rule and policy.  The
    relation arrays count only for the with_rel variant (three operations
    per folded pair and relation run: the run test, the collect bit, the
    closure bit).  Every extent and table byte is the live one
    (``live_extents``: capacity-padded slots and rows are no work the
    call needs).  Returns (ms, bound_by, bytes, ops)."""
    d = kmod._dims(c, r)
    live = live_extents(c)
    d.update({k: live[k] for k in ("S", "KP", "KR", "T")})
    skip = () if with_rel else REL_TABLES + REL_ROWS
    nbytes = sum(live_nbytes(k, c[k], live) for k in kmod.TABLE_ARRAYS
                 if k not in skip)
    nbytes += rows_nbytes(r, [k for k in kmod.ROW_ARRAYS + kmod.BATCH_ARRAYS
                              if k not in skip], live)
    nbytes += 3 * 4 * d["B"]
    test = d["KS"] * d["NSUB"] + d["NROLE"] + d["KA"] * d["NACT"]
    fold = (3 * d["KE"] * d["NR"] + d["KO"] * d["NOP"]
            + d["NP"] * (d["KE"] + 2 * d["KPR"]) + 4 * d["NR"] + 16
            + (3 * d["NRU_REL"] if with_rel else 0))
    pairs = d["B"] * d["T"]
    folded = pairs if every_pair else passing_pairs(c, r, live["t_rows"])
    per_rule, per_policy = 12, 16 + d["KE"] * d["NR"]
    ops = (pairs * test + folded * fold
           + d["B"] * (d["S"] * d["KP"] * d["KR"] * per_rule
                       + d["S"] * d["KP"] * per_policy))
    return _finish_bound(nbytes, ops)


def dense_plain(c, r, with_acl, with_hr, with_rel, explain=False):
    """decide_dense's plain version, stacked as the kernel returns it."""
    return torch.stack(decide_dense_ref(c, r, with_acl, with_hr, with_rel,
                                        explain=explain))


def grouped_plain(inv, cs, g_idx, r, *flags, explain=False):
    """K4's plain version on its wrapper's arguments (the row groups, a
    host array there, as a tensor beside the rows)."""
    return prefilter_ref.decide_grouped_ref(
        inv, cs, torch.as_tensor(g_idx, device=r["r_n_ra"].device), r,
        *flags, explain=explain)


def kernel_vs_plain(c, r, flags):
    """Kernel and plain version on the same device tensors: (kernel out,
    plain out), int32 [3, B] each."""
    got = kmod.decide_dense(c, r, *flags)
    want = dense_plain(c, r, *flags)
    torch.cuda.synchronize()
    return got, want


def explain_key(resp):
    """A response's provenance: ``_rule_id`` and ``_explain``."""
    return (getattr(resp, "_rule_id", None), getattr(resp, "_explain", None))


def response_key(resp):
    st = resp.operation_status
    return (resp.decision, resp.evaluation_cacheable, st.code, st.message,
            [o.to_dict() if hasattr(o, "to_dict") else o
             for o in (resp.obligations or [])])


# ------------------------------------------------------------------ phases


def phase_kernel_vs_plain(device, n_rows: int, stats: dict) -> dict:
    """Phase 3 and 4 over every tree; returns per-variant row counts."""
    variants: dict[tuple, int] = {}
    seen = set()
    n_inel = 0
    for name in tree_names():
        engine = engine_for(name)
        compiled = compile_policies(engine.policy_sets, engine.urns)
        if not compiled.supported or compiled.n_rules == 0:
            log(f"  {name}: not kernel-supported "
                f"({compiled.unsupported_reason or 'no rules'}), skipped")
            continue
        rng = random.Random(zlib.crc32(name.encode()))
        stress = name == "scoped_511"
        with_pairs = grid_requests(rng, n_rows, stress) + odd_requests(rng, stress)
        no_pairs = grid_requests(rng, n_rows, stress, acl=False)
        for reqs in (with_pairs, no_pairs):
            batch = encode_requests(reqs, compiled)
            n_inel += int((~batch.eligible).sum())
            c, b, r, flags = device_inputs(compiled, batch, device)
            got, want = kernel_vs_plain(c, r, flags)
            err = int((got.long() - want.long()).abs().max())
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            if err != 0:
                bad = (got != want).any(0).nonzero().flatten()[:5].tolist()
                raise AssertionError(
                    f"{name}: kernel != plain at rows {bad}: "
                    f"{got[:, bad].tolist()} vs {want[:, bad].tolist()}")
            variants[flags] = variants.get(flags, 0) + b
            dec = got[0, :b].cpu().numpy()
            elig = batch.eligible
            seen.update(int(x) for x in np.unique(dec[elig]))
            # phase 4: the port's scalar oracle on the eligible rows of a
            # 1024-row sample
            host = got[:, :b].cpu().numpy()
            n_checked = 0
            rows = [i for i in range(min(1024, b)) if elig[i]]
            for i, resp in zip(rows, oracle_walks(engine, reqs, rows)):
                cach = resp.evaluation_cacheable
                want_row = (DEC_CODE[resp.decision],
                            -1 if cach is None else int(bool(cach)),
                            resp.operation_status.code)
                if tuple(int(x) for x in host[:, i]) != want_row:
                    raise AssertionError(
                        f"{name}: kernel row {i} {host[:, i].tolist()} "
                        f"!= oracle {want_row}")
                n_checked += 1
            log(f"  {name} (with_acl, with_hr, with_rel)={flags}: {b} rows "
                f"equal to the plain version, {n_checked} equal to the oracle")
    if seen != {0, 1, 2}:
        raise AssertionError(f"decisions seen {sorted(seen)}: need all three")
    if n_inel == 0:
        raise AssertionError("no ineligible rows were generated")
    if not {(a, h, False) for a in (False, True) for h in (False, True)} \
            <= set(variants):
        raise AssertionError(f"variants run: {sorted(variants)}")
    return variants


def phase_end_to_end(device, n_rows: int, stats: dict):
    """Phase 5, the main path: the evaluator on mixed traffic against the
    511-rule scoped tree, every response held against the oracle."""
    engine = engine_for("scoped_511")
    rng = random.Random(5)
    reqs = grid_requests(rng, n_rows - 5, stress=True) + odd_requests(rng, True)
    oracle_reqs = clone(reqs)
    evaluator = HybridEvaluator(engine, device=device)
    reset_launches()
    responses = evaluator.is_allowed_batch(reqs)
    launches = kmod.LAUNCHES["decide_dense"]
    if launches < 1:
        raise AssertionError("the main path launched no decide_dense kernel")
    wants = oracle_walks(engine, oracle_reqs, range(len(oracle_reqs)))
    for i, (resp, want) in enumerate(zip(responses, wants)):
        if response_key(resp) != response_key(want):
            raise AssertionError(
                f"end to end row {i}: {response_key(resp)} != "
                f"{response_key(want)}")
    compiled = evaluator._compiled
    probe = encode_requests(clone(reqs), compiled)
    decisions = {}
    for resp in responses:
        decisions[resp.decision] = decisions.get(resp.decision, 0) + 1
    log(f"  {len(reqs)} responses equal to the oracle; {launches} kernel "
        f"launches; {int((~probe.eligible).sum())} rows served by the oracle;"
        f" decisions {decisions}")
    # the kernel's shapes on this path: the floor-caps sub-batch
    floor = [r for r in clone(reqs)
             if fits_floor(request_needs(r, compiled.urns))]
    batch = encode_requests(floor, compiled, caps=dict(_CAPS_FLOOR))
    c, b, r, flags = device_inputs(compiled, batch, device)
    got, want = kernel_vs_plain(c, r, flags)
    if not torch.equal(got, want):
        raise AssertionError("main-path batch: kernel != plain")
    ms = time_ms(lambda: kmod.decide_dense(c, r, *flags))
    plain_ms = time_ms(lambda: dense_plain(c, r, *flags), 2)
    bms, by, nbytes, ops = bound_ms(c, r)
    stats["main"] = dict(launches=launches, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, rows=int(r["r_n_ra"].shape[0]),
                         bytes=nbytes, ops=ops, args=(c, r) + flags,
                         yardstick_ms=bound_ms(c, r, every_pair=True)[0])
    # end-to-end evaluator throughput (host clock; each call ends in a
    # device sync inside materialize)
    evaluator.is_allowed_batch(reqs)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        evaluator.is_allowed_batch(reqs)
    dt = (time.perf_counter() - t0) / ITERS
    # where that time goes: the host encode and the host-to-device copy of
    # the same two sub-batches, timed alone; the kernel from CUDA events;
    # the rest is decode, oracle rows and launch overhead
    ext = [r for r in clone(reqs)
           if not fits_floor(request_needs(r, compiled.urns))]
    t0 = time.perf_counter()
    batches = [encode_requests(floor, compiled, caps=dict(_CAPS_FLOOR)),
               encode_requests(ext, compiled)]
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    for bt in batches:
        batch_from_numpy(bt, device, keys=kmod.ROW_ARRAYS)
    torch.cuda.synchronize()
    t_carry = time.perf_counter() - t0
    stages = {"encode": t_encode * 1e3, "carry": t_carry * 1e3,
              "kernel_floor_batch": ms}
    stages["rest"] = dt * 1e3 - sum(stages.values())
    stats["e2e"] = dict(rows=len(reqs), seconds=dt,
                        decisions_per_s=len(reqs) / dt, stages_ms=stages)


def phase_throughput(device, name: str, total: int, card: str) -> dict:
    """Phase 6: the kernel and the plain version on one large batch."""
    engine = engine_for(name)
    compiled = compile_policies(engine.policy_sets, engine.urns)
    stress = name == "scoped_511"
    batch = bench_batch(compiled, 4096, total, stress=stress)
    torch.cuda.reset_peak_memory_stats()
    c, b, r, flags = device_inputs(compiled, batch, device)
    got, want = kernel_vs_plain(c, r, flags)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain at {total} rows")
    dec = got[0].cpu().numpy()
    shares = {k: float((dec == v).mean()) for k, v in DEC_CODE.items()}
    if not stress and not 0.45 <= shares["PERMIT"] <= 0.55:
        raise AssertionError(f"seed PERMIT share {shares['PERMIT']}")
    ms = time_ms(lambda: kmod.decide_dense(c, r, *flags))
    plain_ms = time_ms(lambda: dense_plain(c, r, *flags), 2)
    bms, by, nbytes, ops = bound_ms(c, r)
    out = dict(config=name, rows=total, kernel_ms=ms,
               kernel_decisions_per_s=total / (ms / 1e3), plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
               shares=shares, max_memory_allocated=torch.cuda.max_memory_allocated(),
               card=card)
    log("  " + json.dumps(out))
    return out


# ------------------------------------------------- signature path: trees


def small_stress_doc(scoped: bool = False, conditions: bool = False):
    """The 720-rule stress tree of the JAX package's prefilter tests
    (6 permit-overrides policies of 120 rules over 16 entities, role %
    23), copied here.  ``scoped=True`` adds a roleScopingEntity to every
    rule (HR on every target row); ``conditions=True`` puts a condition on
    every seventh rule, one that raises for requests without a subject id
    (an abort) and holds otherwise."""
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    policies = []
    rid = 0
    for p in range(6):
        rules = []
        for q in range(120):
            subjects = [{"id": URNS["role"], "value": f"role-{rid % 23}"}]
            if scoped:
                subjects.append({"id": URNS["roleScopingEntity"],
                                 "value": ORG})
            rule = {
                "id": f"r{rid}",
                "target": {
                    "subjects": subjects,
                    "resources": [{"id": URNS["entity"],
                                   "value": STRESS_ENTITIES[(p * 31 + q) % 16]}],
                    "actions": [{"id": URNS["actionID"],
                                 "value": actions[rid % len(actions)]}],
                },
                "effect": "PERMIT" if rid % 3 else "DENY",
            }
            if conditions and rid % 7 == 0:
                rule["condition"] = "context.subject.id.startswith('u')"
            rules.append(rule)
            rid += 1
        policies.append({"id": f"p{p}", "combining_algorithm": PO,
                         "rules": rules})
    return {"policy_sets": [{"id": "stress", "combining_algorithm": DO,
                             "policies": policies}]}


def engine_from_doc(doc) -> AccessController:
    engine = AccessController()
    for ps in load_policy_sets(doc):
        engine.update_policy_set(ps)
    return engine


# ----------------------------------------------- signature path: traffic


def stress_traffic(n: int, seed: int = 7, n_acl: int = 0) -> list[Request]:
    """The JAX package's ``bench_stress`` traffic (copied): roles drawn
    from 108 (97 exist), entities from 72 (64 exist), actions in turn, no
    HR context.  ``n_acl`` spreads that many rows with an ACL pair (a
    create on an organization instance) over the batch."""
    rng = np.random.default_rng(seed)
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    acl_rows = set(range(0, n, max(1, n // n_acl))) if n_acl else set()
    out = []
    for i in range(n):
        role = f"role-{int(rng.integers(108))}"
        k = int(rng.integers(72))
        resources = []
        if i in acl_rows:
            resources = [{"id": f"res-{i}", "meta": {"owners": [], "acls": [{
                "id": URNS["aclIndicatoryEntity"], "value": ORG,
                "attributes": [{"id": URNS["aclInstance"],
                                "value": OWNERS[i % 4]}]}]}}]
        out.append(Request(
            target=Target(
                subjects=[Attribute(id=URNS["role"], value=role),
                          Attribute(id=URNS["subjectID"], value=f"u{i}")],
                resources=[
                    Attribute(id=URNS["entity"],
                              value=f"urn:restorecommerce:acs:model:"
                                    f"stress{k}.Stress{k}"),
                    Attribute(id=URNS["resourceID"], value=f"res-{i}"),
                ],
                actions=[Attribute(id=URNS["actionID"],
                                   value=actions[i % 4])],
            ),
            context={"resources": resources, "subject": {
                "id": f"u{i}",
                "role_associations": [{"role": role, "attributes": []}],
                "hierarchical_scopes": [],
            }},
        ))
    return out


def stress_hr_traffic(n: int, seed: int = 13) -> list[Request]:
    """The JAX package's ``bench_stress_hr`` traffic (copied): every row
    role-scoped to org-0 with a 7-child HR tree and an owner drawn from 12
    organizations (about 2/3 inside the tree)."""
    rng = np.random.default_rng(seed)
    orgs = [f"org-{j}" for j in range(12)]
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    out = []
    for i in range(n):
        role = f"role-{int(rng.integers(108))}"
        k = int(rng.integers(72))
        tree = [{"id": orgs[0], "role": role,
                 "children": [{"id": o} for o in orgs[1:8]]}]
        out.append(build_request(
            subject_id=f"u{i}", subject_role=role,
            role_scoping_entity=ORG, role_scoping_instance=orgs[0],
            resource_type=f"urn:restorecommerce:acs:model:stress{k}.Stress{k}",
            resource_id=f"res-{i}", action_type=actions[i % 4],
            owner_indicatory_entity=ORG,
            owner_instance=orgs[int(rng.integers(len(orgs)))],
            hierarchical_scopes=tree,
        ))
    return out


def wia_large_requests(n: int) -> list[Request]:
    """The JAX package's ``bench_wia_large`` traffic (copied): roles
    ``i % 97``, subjects ``u{i}``, one of the 64 stress entities drawn
    from ``random.Random(3)``, actions in turn."""
    rng = random.Random(3)
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    out = []
    for i in range(n):
        k = rng.randint(0, 63)
        role = f"role-{i % 97}"
        out.append(Request(
            target=Target(
                subjects=[Attribute(id=URNS["role"], value=role),
                          Attribute(id=URNS["subjectID"], value=f"u{i}")],
                resources=[Attribute(id=URNS["entity"],
                                     value=STRESS_ENTITIES[k])],
                actions=[Attribute(id=URNS["actionID"],
                                   value=actions[i % 4])],
            ),
            context={"resources": [], "subject": {
                "id": f"u{i}",
                "role_associations": [{"role": role, "attributes": []}],
                "hierarchical_scopes": [],
            }},
        ))
    return out


# --------------------------------------- signature path: kernel vs plain


def _max_err(got, want) -> int:
    if isinstance(got, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"plane names differ: {sorted(got)}")
        return max((_max_err(got[k], want[k]) for k in got), default=0)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


PLAIN = {
    "sig_planes": prefilter_ref.sig_planes_ref,
    "sig_decide": prefilter_ref.sig_decide_ref,
    "decide_grouped": grouped_plain,
    "decide_dense": dense_plain,
    "rule_chunk": shard_ref.rule_chunk_ref,
    "set_chunk": shard_ref.set_chunk_ref,
    "shard_tail": shard_ref.shard_tail_ref,
}
# the variant flags at the end of each wrapper's arguments
N_FLAGS = {"sig_planes": 2, "sig_decide": 2, "decide_grouped": 3,
           "decide_dense": 3, "rule_chunk": 3, "set_chunk": 3,
           "shard_tail": 0, "wia_planes": 0}
# the modules that call each wrapper (each imports it by name)
SITES = {"sig_planes": (pfmod,), "sig_decide": (pfmod,),
         "decide_grouped": (pfmod,), "decide_dense": (kmod, mmod),
         "rule_chunk": (rule_shard,), "set_chunk": (pod_shard,),
         "shard_tail": (rule_shard, pod_shard)}
SIG_KERNELS = ("sig_planes", "sig_decide", "decide_grouped")
# the plane kernels' plain versions (K5's calls are held by WiaCheck, so
# it has no entry in PLAIN, whose every name KernelCheck can wrap)
PLANES_PLAIN = {"sig_planes": prefilter_ref.sig_planes_ref,
                "wia_planes": reverse_ref.wia_planes_ref}


class KernelCheck:
    """While active, every call of the wrappers in ``names`` (by default
    the three the prefilter makes, and with ``dense`` also
    ``decide_dense``) launches the kernel, then runs the plain version on
    the same device tensors; any difference raises.  Records per kernel
    the calls, the largest error and the variants (flag tuples) run, and
    keeps the arguments of each kernel's calls (device tensors, untouched;
    ``args`` the last, ``calls`` all) for the timing phases.  Explain
    calls (keyword ``explain=True``) count under the kernel's name too
    (``explain_calls``, ``explain_err``), and their arguments are kept
    under ``<name>+explain`` with their keywords in ``kw``."""

    def __init__(self, stats: dict, dense: bool = False, names=None):
        self.stats = stats
        self.args: dict[str, tuple] = {}
        self.calls: dict[str, list] = {}
        self.kw: dict[str, dict] = {}
        self._saved = []
        self._names = names or SIG_KERNELS + (("decide_dense",) if dense
                                              else ())

    def __enter__(self):
        for name in self._names:
            for mod in SITES[name]:
                orig = getattr(mod, name)
                self._saved.append((mod, name, orig))
                setattr(mod, name, self._checked(name, orig))
        return self

    def _checked(self, name: str, orig):
        def checked(*args, **kw):
            key = name + ("+explain" if kw.get("explain") else "")
            self.args[key] = args
            self.calls.setdefault(key, []).append(args)
            self.kw[key] = kw
            got = orig(*args, **kw)
            want = PLAIN[name](*args, **kw)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            st = self.stats.setdefault(name, {"calls": 0, "max_abs_err": 0,
                                              "variants": set()})
            st["calls"] += 1
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["variants"].add(tuple(bool(f) for f in
                                     args[len(args) - N_FLAGS[name]:]))
            if kw.get("explain"):
                st["explain_calls"] = st.get("explain_calls", 0) + 1
                st["explain_err"] = max(st.get("explain_err", 0), err)
            if err != 0:
                raise AssertionError(f"{key}: kernel != plain "
                                     f"(max abs err {err})")
            return got

        return checked

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        return False


def reset_launches() -> None:
    for k in kmod.LAUNCHES:
        kmod.LAUNCHES[k] = 0


def phase_sig_vs_plain(device, stats: dict) -> None:
    """Phase 6: every signature-path kernel call on a spread of trees and
    batches, held against its plain version."""
    cases = []
    for name in ("basic_policies.yml", "policy_set_targets.yml",
                 "role_scopes.yml", "conditions.yml", "acl_policies.yml",
                 "props_multi_rules_entities.yml", "ops_multi.yml"):
        engine = engine_for(name)
        rng = random.Random(zlib.crc32(name.encode()))
        cases.append((name, engine, True, grid_requests(rng, 128)))
        cases.append((name + " (signature rows)", engine, True,
                      grid_requests(rng, 128, acl=False, props=False)))
    for label, kw in (("stress-720", {}), ("stress-720 HR", {"scoped": True}),
                      ("stress-720 conditions", {"conditions": True})):
        engine = engine_from_doc(small_stress_doc(**kw))
        rng = random.Random(zlib.crc32(label.encode()))
        reqs = grid_requests(rng, 512, stress=True, acl=False)
        for r in reqs[::5]:  # no subject id: the conditions abort
            r.context["subject"].pop("id", None)
        cases.append((label, engine, False, reqs))
        cases.append((label + " ACL", engine, False,
                      grid_requests(rng, 256, stress=True)))
    with KernelCheck(stats):
        for label, engine, force, reqs in cases:
            compiled = compile_policies(engine.policy_sets, engine.urns)
            kern = pfmod.PrefilteredKernel(compiled, device=device)
            if force:
                kern.active = True
                kern._dense = None
            before = {k: v["calls"] for k, v in stats.items()}
            dec = kern.evaluate(encode_requests(clone(reqs), compiled))
            ran = sorted(k for k, v in stats.items()
                         if v["calls"] > before.get(k, 0))
            aborts = int((dec[2] != 200).sum())
            log(f"  {label}: {len(reqs)} rows, kernels {ran} equal to their "
                f"plain versions; {aborts} abort rows; needs_hr={kern.needs_hr}")
    missing = [k for k in SIG_KERNELS
               if stats.get(k, {}).get("calls", 0) == 0]
    if missing:
        raise AssertionError(f"phase 6 never ran {missing}")


# --------------------------------------- signature path: the main paths


# the oracle walks of the checks are pure host code: forked processes
# walk them side by side (none touches the card)
ORACLE_PROCS = 6
# threads that hold no lock a forked walker takes, so they do not stop a
# fork: a cluster's pipe readers (phase 24's broker lives from phase 2
# on) and the idle workers of the transport's module-level serializer
# pool (ThreadPoolExecutor re-initialises its own lock in a forked child)
FORK_SAFE_THREADS = ("cluster-drain-", "acs-pb-ser")
ORACLE_WALKS = {"forked": 0, "here": 0}
_ORACLE = None  # (engine, requests, candidate index or None) for a walker


def _oracle_walk(i: int):
    engine, requests, cand, reverse = _ORACLE
    req = clone(requests[i])
    if reverse:
        return engine.what_is_allowed(req)
    if cand is None:
        return engine.is_allowed(req)
    return engine.is_allowed(
        req, candidate_rules=cand.candidates(req, engine.urns))


def oracle_walks(engine, requests, idx, cand=None,
                 reverse: bool = False) -> list:
    """``engine.is_allowed`` on a copy of ``requests[i]`` for each ``i``
    of ``idx`` (over ``cand``'s candidate rules when given;
    ``engine.what_is_allowed`` with ``reverse``), in order.
    With no other thread in this process (a fork would copy a held lock)
    the walks run in ``ORACLE_PROCS`` forked processes, else here."""
    global _ORACLE
    idx = list(idx)
    _ORACLE = (engine, requests, cand, reverse)
    try:
        others = [t for t in threading.enumerate()
                  if t is not threading.current_thread()
                  and not t.name.startswith(FORK_SAFE_THREADS)]
        if len(idx) < 2 * ORACLE_PROCS or others:
            ORACLE_WALKS["here"] += len(idx)
            return [_oracle_walk(i) for i in idx]
        ORACLE_WALKS["forked"] += len(idx)
        # the walkers' collector leaves the inherited heap (the large
        # trees built ahead of their phases among it) untouched, so its
        # pages stay shared
        gc.freeze()
        try:
            with multiprocessing.get_context("fork").Pool(
                    ORACLE_PROCS) as pool:
                return pool.map(
                    _oracle_walk, idx,
                    chunksize=max(1, len(idx) // (4 * ORACLE_PROCS)))
        finally:
            gc.unfreeze()
    finally:
        _ORACLE = None


def sample_oracle(engine, requests, responses, n: int = 32,
                  always=()) -> int:
    """``n`` random rows, and every row of ``always``, against the
    oracle."""
    idx = sorted(set(random.Random(3).sample(range(len(requests)),
                                             min(n, len(requests))))
                 | set(always))
    for i, want in zip(idx, oracle_walks(engine, requests, idx)):
        if response_key(responses[i]) != response_key(want):
            raise AssertionError(f"row {i}: {response_key(responses[i])} != "
                                 f"oracle {response_key(want)}")
    return len(idx)


def checked_call(label: str, fn, expect, stats: dict, dense: bool = False):
    """Counts to 0, ``fn()`` with every kernel call held against its plain
    version, counts read; fails if a kernel of ``expect`` never launched.
    Returns (fn's result, launches, the KernelCheck)."""
    check: dict = {}
    reset_launches()
    with KernelCheck(check, dense=dense) as chk:
        out = fn()
    launches = dict(kmod.LAUNCHES)
    for k, v in check.items():
        st = stats.setdefault(k, {"calls": 0, "max_abs_err": 0,
                                  "variants": set()})
        st["max_abs_err"] = max(st["max_abs_err"], v["max_abs_err"])
    for k in expect:
        if launches[k] < 1:
            raise AssertionError(f"{label}: the main path launched no {k}")
    return out, launches, chk


def run_main_path(label: str, evaluator, engine, requests, expect, stats,
                  always=()):
    """One main path: counts to 0, one ``is_allowed_batch`` with every
    kernel call held against its plain version, counts read; then a
    sample, with the rows of ``always``, against the oracle.  Returns
    (launches, the arguments of each kernel's last call)."""
    responses, launches, chk = checked_call(
        label, lambda: evaluator.is_allowed_batch(requests), expect, stats)
    n = sample_oracle(engine, requests, responses, always=always)
    decisions: dict = {}
    for resp in responses:
        decisions[resp.decision] = decisions.get(resp.decision, 0) + 1
    log(f"  {label}: {len(requests)} rows; launches {launches}; every "
        f"kernel call equal to its plain version; {n} sampled responses "
        f"equal to the oracle; decisions {decisions}")
    return launches, chk.args


def steady_state(evaluator, requests, iters: int = 3) -> dict:
    """Evaluator decisions/s with warm caches (host clock, each batch
    ends in a device sync inside materialize) and the stage split of one
    batch: encode, host grouping/packing/launch, device wait + readback,
    decode."""
    evaluator.is_allowed_batch(requests)
    t0 = time.perf_counter()
    for _ in range(iters):
        evaluator.is_allowed_batch(requests)
    dt = (time.perf_counter() - t0) / iters
    kernel, compiled = evaluator._kernel, evaluator._compiled
    t0 = time.perf_counter()
    batch = encode_requests(requests, compiled,
                            evaluator.engine.resource_adapter)
    t1 = time.perf_counter()
    thunk = kernel.evaluate_async(batch)
    t2 = time.perf_counter()
    out = thunk()
    t3 = time.perf_counter()
    evaluator._decode_batch(requests, batch, out)
    t4 = time.perf_counter()
    return {
        "rows": len(requests), "batch_ms": dt * 1e3,
        "decisions_per_s": len(requests) / dt,
        "stages_ms": {"encode": (t1 - t0) * 1e3,
                      "group_pack_launch": (t2 - t1) * 1e3,
                      "device_wait_readback": (t3 - t2) * 1e3,
                      "decode": (t4 - t3) * 1e3},
    }


def h2d_ms(t: torch.Tensor) -> float:
    """A pinned host copy of ``t``'s shape to the card, CUDA events."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return time_ms(lambda: host.to(t.device, non_blocking=True))


# ------------------------------------------------------ bounds (per call)


def live_target_rows(t: dict) -> torch.Tensor | None:
    """The target rows of table dict ``t`` that a valid set, policy or
    rule references (row 0 backs "no target"), as indices: the evaluator
    serves ``full_bucketed_compile``'s tables, whose pad rows (and, after
    a patch, rows no node references any more) no call needs.  None for
    stacked group tables (K2-K4's, which ``compact_rules`` already cut to
    the rows their nodes reference) and for a dict without the node
    arrays."""
    need = ("rule_target", "rule_valid", "rule_has_target", "pol_target",
            "pol_valid", "pol_has_target", "set_target", "set_valid",
            "set_has_target")
    if t["t_role"].dim() != 1 or any(k not in t for k in need):
        return None
    mask = torch.zeros(t["t_role"].shape[0], dtype=torch.bool,
                       device=t["t_role"].device)
    mask[0] = True
    for node in ("rule", "pol", "set"):
        hit = t[node + "_valid"] & t[node + "_has_target"]
        mask[t[node + "_target"][hit].long()] = True
    return mask.nonzero().flatten()


def compiled_target_rows(compiled) -> torch.Tensor:
    """``live_target_rows`` of a ``CompiledPolicies`` (host arrays)."""
    return live_target_rows({k: torch.as_tensor(v)
                             for k, v in compiled.arrays.items()})


def live_extents(t: dict) -> dict:
    """The live extents of table dict ``t`` (any of the kernels' table
    dicts, capacity-padded or not, with or without a leading group axis)
    and the share of each padded class of array they leave: ``S`` the
    valid set slots, ``KP`` the most valid policies of a set, ``KR`` the
    most rules of a policy (no more than the table's rule axis: a
    compacted one), ``T`` the referenced target rows
    (``live_target_rows``; the table's own for stacked tables), ``W`` the
    entity-vocab rows those rows reference (the only rows of the batch's
    [W, E] regex matrices a call reads; the sentinel rows are never
    referenced; None without ``t_ent_w``), ``RV`` the (role, scoping)
    vocab entries they reference (the owner bitplanes' entries; None
    without ``t_rs_idx``).  An extent whose mask ``t``
    lacks stays the table's own.  On an unpadded compile every extent of
    a whole table equals its shape, so those bounds do not change
    there."""
    src = t["rule_valid"] if "rule_valid" in t else t["rule_effect"]
    S, KP, KR = (int(x) for x in src.shape[-3:])
    s_l, kp_l, kr_l = S, KP, KR
    if "set_valid" in t:
        s_l = int(t["set_valid"].reshape(-1, S).sum(-1).max())
    elif "pol_valid" in t:
        s_l = int(t["pol_valid"].reshape(-1, S, KP).any(-1).sum(-1).max())
    if "pol_valid" in t:
        kp_l = int(t["pol_valid"].reshape(-1, KP).sum(-1).max())
    if "pol_n_rules" in t:
        kr_l = min(KR, int(t["pol_n_rules"].max()))
    T = int(t["t_role"].shape[-1]) if "t_role" in t else 0
    rows = live_target_rows(t) if "t_role" in t else None
    t_l = T if rows is None else int(rows.numel())
    # the regex matrices and the owner bitplanes keep one row / entry
    # for an empty vocab
    w_l = rv_l = None
    if "t_ent_w" in t:
        w = t["t_ent_w"] if rows is None else t["t_ent_w"][rows]
        w_l = max(int(torch.unique(w[w >= 0]).numel()), 1)
    if "t_rs_idx" in t:
        rs = t["t_rs_idx"] if rows is None else t["t_rs_idx"][rows]
        rv_l = max(int(torch.unique(rs[rs >= 0]).numel()), 1)
    return {"S": s_l, "KP": kp_l, "KR": kr_l, "T": t_l, "t_rows": rows,
            "W": w_l, "RV": rv_l, "share": {
                "set": s_l / max(S, 1), "pol": s_l * kp_l / max(S * KP, 1),
                "rule": s_l * kp_l * kr_l / max(S * KP * KR, 1),
                "t": t_l / max(T, 1)}}


def live_nbytes(name: str, x: torch.Tensor, live: dict) -> int:
    """The bytes of array ``name`` that its live slots hold: a set,
    policy or rule array (and K2's planes of each: ``ss_`` / ``sl_`` /
    ``multi_ok``, ``pp_`` / ``pl_``, ``rl_``) by the live share of its
    slots, a target-table column by the live rows', the regex matrices
    ([W, E]) by the referenced vocab rows'."""
    share = live["share"]
    if name.startswith(("rule_", "rl_")):
        f = share["rule"]
    elif name.startswith(("pol_", "pp_", "pl_")):
        f = share["pol"]
    elif name.startswith(("set_", "ss_", "sl_")) or name == "multi_ok":
        f = share["set"]
    elif name.startswith("t_"):
        f = share["t"]
    elif name in ("rgx_set", "pfx_neq") and live["W"] is not None:
        f = live["W"] / max(int(x.shape[-2]), 1)  # [(G,) W, E]
    else:
        f = 1.0
    return int(round(int(x.nbytes) * f))


def own_words(live: dict, width: int, nru: int, nop: int) -> int:
    """The int32 words of a row's owner bitplanes (``r_own_bits``, packed
    per ``encode.owner_bit_layout``) over the live (role, scoping) vocab
    entries, at most ``width`` (the words the rows carry: a pad entry's
    bits are never read, a stage-B-free tree's one word is a dummy)."""
    if live["RV"] is None:
        return width
    return min(width, owner_bit_layout(live["RV"], nru, nop)[3])


def rows_nbytes(r: dict, keys, live: dict) -> int:
    """The bytes of the row and batch arrays ``keys`` of ``r``, each at
    its live extent (``live_nbytes``; ``r_own_bits`` by ``own_words``)."""
    n = 0
    for k in keys:
        if k == "r_own_bits":
            B, width = r[k].shape
            n += 4 * B * own_words(live, width, r["r_own_runs"].shape[1],
                                   r["r_op_vals"].shape[1])
        else:
            n += live_nbytes(k, r[k], live)
    return n


def _finish_bound(nbytes: int, ops: int) -> tuple[float, str, int, int]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


# the stacked target-table columns K2 reads for the planes, by variant
# (the pseudo-requests carry no properties, so the property and tail
# columns decide nothing)
SIG_PLANES_READS = (
    "t_n_subjects", "t_role", "t_has_role", "t_skip_acl", "t_sub_ids",
    "t_sub_vals", "t_act_ids", "t_act_vals", "t_ent_vals", "t_ent_w",
    "t_op_vals", "t_has_props", "t_n_res", "rule_effect", "rule_target",
    "pol_target", "set_target")
SIG_PLANES_HR_READS = ("t_has_scoping", "t_hr_check", "t_rs_idx")


def bound_sig_planes(tabs, inv, pseudo, with_hr, with_rel, out,
                     every_table: bool = False):
    """Bytes: the stacked columns the planes read (``SIG_PLANES_READS``,
    the HR and relation ones in their variants), the policy arrays and
    pseudo-requests read once, the planes written once; with
    ``every_table`` every stacked table (the count PRs 2-10 used, now the
    yardstick).  Operations: stage A's compares per target row of every
    group, one per live plane element written.  Set, policy and rule
    slots count live (``live_extents``)."""
    reads = SIG_PLANES_READS + (SIG_PLANES_HR_READS if with_hr else ()) \
        + (REL_TABLES if with_rel else ())
    live = live_extents({**inv, **tabs})
    nbytes = sum(live_nbytes(k, t, live) for k, t in tabs.items()
                 if (with_rel or k not in REL_TABLES)
                 and (every_table or k in reads))
    nbytes += sum(live_nbytes(k, inv[k], live)
                  for k in kmod.SIG_PLANES_INPUTS if k in inv)
    nbytes += sum(live_nbytes(k, t, live) for k, t in pseudo.items())
    planes = {k: live_nbytes(k, t, live) for k, t in out.items()}
    nbytes += sum(planes.values())
    written = sum(n // out[k].element_size() for k, n in planes.items())
    G, T = tabs["t_role"].shape
    KA, KE, KO = (tabs[k].shape[2] for k in ("t_act_ids", "t_ent_vals",
                                             "t_op_vals"))
    NACT, NR, NOP = (pseudo[k].shape[1] for k in ("r_act_ids", "r_ent_vals",
                                                  "r_op_vals"))
    per_target = KA * NACT + 3 * KE * NR + KO * NOP + 4 * NR + 16
    return _finish_bound(nbytes, G * T * per_target + written)


def bound_sig_decide(args) -> tuple[float, str, int, int]:
    """Bytes: the packed rows, slot maps and outputs, the group planes and
    rule arrays read once.  Operations: per real row, the subject fold,
    owner checks and combine compares of every rule position of its group
    and the policy and set folds.  Set, policy and rule slots count live
    (``live_extents``)."""
    (inv, cs, planes, slot_g, rows, g2r, gp, n_rows, schedule,
     needs_pairs, with_hr, with_rel) = args
    live = live_extents({**inv, **cs})
    nbytes = sum(int(t.nbytes) for t in (slot_g, rows, g2r, gp))
    nbytes += 3 * 4 * int(gp.shape[0])
    nbytes += sum(live_nbytes(k, t, live) for k, t in planes.items())
    nbytes += sum(live_nbytes(k, t, live) for k, t in cs.items())
    nbytes += sum(live_nbytes(k, inv[k], live) for k in kmod.SIG_DECIDE_INV)
    widths = {k: w for k, w, _ in schedule}
    S, KP, KR = live["S"], live["KP"], live["KR"]
    nrole, nsub = widths["r_roles"], widths["r_sub_ids"]
    ks = planes["rl_sub_ids"].shape[-1]
    sub = nrole + (ks * nsub if needs_pairs else 0)
    hr = (widths.get("r_own_runs", 0) + planes["rl_op_hit"].shape[-1]
          if with_hr else 0)
    hr += 3 * widths.get("r_rel_runs", 0) if with_rel else 0
    per_row = S * KP * KR * (sub + hr + 12) + S * KP * (2 * sub + hr + 20) \
        + S * (sub + 12)
    return _finish_bound(nbytes, n_rows * per_row)


def time_steady(*fns) -> list[float]:
    """Milliseconds per launch of each of ``fns`` (CUDA events): after a
    warm-up, STEADY_WINDOWS windows of STEADY_ITERS launches each, the
    functions taking turns window by window (a, b, b, a, ...), the median
    window per function."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per: list[list[float]] = [[] for _ in fns]
    for w in range(STEADY_WINDOWS):
        order = range(len(fns)) if w % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start.record()
            for _ in range(STEADY_ITERS):
                fns[i]()
            end.record()
            end.synchronize()
            per[i].append(start.elapsed_time(end) / STEADY_ITERS)
    return [sorted(p)[len(p) // 2] for p in per]


def occupancy(name: str, args: tuple, **kw) -> int:
    """Resident blocks per SM of a redesigned kernel's variant at one
    call's shapes."""
    fn = {"sig_decide": kmod.sig_decide_occupancy,
          "decide_grouped": kmod.decide_grouped_occupancy,
          "decide_dense": kmod.decide_dense_occupancy,
          "set_chunk": kmod.set_chunk_occupancy,
          "rule_chunk": kmod.rule_chunk_occupancy,
          "shard_tail": kmod.shard_tail_occupancy,
          "sig_planes": kmod.sig_planes_occupancy,
          "wia_planes": kmod.wia_planes_occupancy}[name]
    return fn(*args, **kw)


def library_of(mod, name: str):
    """A redesigned kernel's loaded library in ``mod`` (the port's
    ``ops.kernel``, or the parent tree's copy of it from
    ``load_parent``, whose tail library has no loader of its own)."""
    if name == "sig_decide":
        return mod._sig_library()
    if name == "decide_grouped":
        return mod._grouped_library()
    if name == "decide_dense":
        return mod._dense_library()
    if name == "shard_tail":
        return mod._library("shard_tail", mod.TAIL_PTRS, mod.TAIL_DIMS, 2)
    if name == "sig_planes":
        return mod._library("sig_planes", mod.SIG_PLANES_PTRS,
                            mod.SIG_PLANES_DIMS, 2)
    if name == "wia_planes":
        return mod._library("wia_planes", mod.WIA_PLANES_PTRS,
                            mod.WIA_PLANES_DIMS, 0)
    return mod._chunk_library()


def prepacked(mod, name: str, args: tuple, explain: bool = False,
              kw: dict | None = None, live: bool | None = None):
    """A redesigned kernel's launch on one call's arguments packed once
    by ``mod`` (the port's ``ops.kernel``, or the parent tree's copy of
    it from ``load_parent``) and launched through its library: what
    ``time_steady`` times, the kernel without the wrapper's host packing.
    ``set_chunk`` takes ``kw["t_live"]``: the port's kernel runs on the
    live target rows, the parent's on the whole table unless ``live``;
    ``shard_tail`` ``kw["kr_stride"]``, in its library's block shape (the
    parent's: its ``TAIL_THREADS``).  ``sig_planes`` and ``wia_planes``
    have no explain flag."""
    kw = kw or {}
    flags = tuple(bool(f) for f in args[len(args) - N_FLAGS[name]:])
    pre: tuple = ()
    keep: tuple = ()
    if name in ("sig_planes", "wia_planes"):
        if name == "sig_planes":
            out, buf, ptrs, dims, threads = mod.pack_sig_planes(*args)
            keep = (buf,)
        else:
            out, ptrs, dims, threads = mod.pack_wia_planes(*args)
        entry = getattr(library_of(mod, name), "acs_" + name)
        stream = torch.cuda.current_stream().cuda_stream

        def launch_planes():
            code = entry(ctypes.addressof(ptrs), len(ptrs),
                         ctypes.addressof(dims), len(dims),
                         *(int(f) for f in flags), threads, stream)
            if code != 0:
                raise RuntimeError(f"{name} launch: {code}")
        launch_planes.keep = (args, out) + keep
        launch_planes.dims = dims
        return launch_planes
    if name == "sig_decide":
        (inv, cs, planes, slot_g, rows, g2r, gp, _, schedule, needs_pairs,
         with_hr, with_rel) = args
        out, ptrs, dims = mod.pack_sig_decide(
            inv, cs, planes, slot_g, rows, g2r, gp, schedule, needs_pairs,
            with_hr, with_rel, explain)
        threads = mod.SIG_DECIDE_THREADS
    elif name == "shard_tail":
        merge, n_model, tabs = args
        out, ptrs, dims, mode = mod.pack_shard_tail(
            merge, n_model, tabs, explain, kw.get("kr_stride", 0))
        pre = (mode,)
        threads = (mod.tail_block(library_of(mod, name), mode)["threads"]
                   if hasattr(mod, "tail_block") else mod.TAIL_THREADS[mode])
    elif name == "rule_chunk":
        packed = mod.pack_chunk_args("rule_chunk", shard_ref.MODE_RULE,
                                     *args[:6])
        pre = (shard_ref.MODE_RULE,)
        out, ptrs, dims, threads = (packed.out, packed.ptrs, packed.dims,
                                    packed.threads)
    else:
        if name == "decide_grouped":
            packed, layout = mod._grouped_args(*args[:4], explain)
            keep = (layout,)
        elif name == "decide_dense":
            packed = mod.pack_args(args[0], args[1], explain=explain)
        else:
            c, r, s_offset, n_model, rank = args[:5]
            if live if live is not None else mod is kmod:
                c = shard_ref.live_rows(c, kw.get("t_live"))
            packed = mod.pack_chunk_args(
                "set_chunk", shard_ref.MODE_SET, c, r, s_offset,
                c["rule_valid"].shape[2], n_model, rank, explain)
            pre = (shard_ref.MODE_SET,)
            keep = (c,)
        out, ptrs, dims, threads = (packed.out, packed.ptrs, packed.dims,
                                    packed.threads)
    entry = getattr(library_of(mod, name), "acs_" + (
        "shard_chunk" if name in ("set_chunk", "rule_chunk") else name))
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = entry(ctypes.addressof(ptrs), len(ptrs),
                     ctypes.addressof(dims), len(dims), *pre,
                     *(int(f) for f in flags), int(explain), threads,
                     stream)
        if code != 0:
            raise RuntimeError(f"{name} launch: {code}")
    launch.keep = (args, out) + keep  # what the packed pointers point at
    launch.dims = dims
    return launch


# the parent tree's ops.kernel (load_parent), when --parent-csrc names one
PARENT = None


def load_parent(csrc: str, lib_dir: str):
    """The parent tree's ``ops/kernel.py`` (beside ``csrc``) loaded as a
    module of the port's ops package, over the port's modules that it
    imports, with the libraries of the redesigned kernels phase 2 built
    from ``csrc`` into ``lib_dir``: its wrappers and packing, to time the
    parent's kernels beside the new on the same arguments."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "access_control_srv_tpu_torch.ops.parent_kernel",
        os.path.join(os.path.dirname(os.path.abspath(csrc)), "kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = cuda_build.load
    cuda_build.load = lambda name: ctypes.CDLL(
        os.path.join(lib_dir, f"lib{name}.so"))
    try:
        for name in REDESIGNED:
            library_of(mod, name)
    finally:
        cuda_build.load = saved
    return mod


def parent_kw(pw, ekw: dict) -> tuple[dict, bool | None]:
    """The keywords of a call for the parent tree's wrapper ``pw``, and
    whether its packed launch takes the live rows: ``t_live`` only where
    that wrapper takes it (a tree before it gets the whole padded table,
    as its main path did)."""
    import inspect

    if "t_live" in inspect.signature(pw).parameters:
        return ekw, True
    return {k: v for k, v in ekw.items() if k != "t_live"}, None


def redesigned_times(name: str, args: tuple, explains: tuple = (False,),
                     kw: dict | None = None) -> dict:
    """A redesigned kernel on one call's arguments (and keywords ``kw``:
    ``set_chunk``'s ``t_live``), for each explain flag of ``explains``
    (keys of the second suffixed ``_explain_off``): ``ms`` the mean of
    ITERS launches through the wrapper after a warm-up (as every kernel
    of the kernel table is timed), ``kernel_ms`` the median window of
    ``time_steady`` over ``prepacked`` launches, and the resident blocks
    per SM; with ``PARENT`` the parent tree's kernel on the same
    arguments (for ``set_chunk`` the live rows where the parent's wrapper
    takes ``t_live``, else the whole padded table, as its main path gave
    it: ``parent_kw``), ``parent_ms`` through its wrapper and
    ``parent_kernel_ms`` timed window by window in turns with
    ``kernel_ms`` (and ``parent_live_kernel_ms``: the parent's
    ``set_chunk`` on the live rows)."""
    wrapper = getattr(kmod, name)
    kw = kw or {}
    out: dict = {}
    fns, keys = [], []
    new_args = args
    if "t_live" in kw:  # as PodShardedKernel passes them: cut once
        new_args = (shard_ref.live_rows(args[0], kw["t_live"]),) + args[1:]
    for i, explain in enumerate(explains):
        sfx = "_explain_off" if i else ""
        ekw = {**kw, **({"explain": True} if explain else {})}
        out["ms" + sfx] = time_ms(lambda: wrapper(*new_args, **ekw))
        out["blocks_per_sm" + sfx] = occupancy(name, args, **ekw)
        fns.append(prepacked(kmod, name, args, explain, kw))
        keys.append("kernel_ms" + sfx)
        if PARENT is None:
            continue
        pw = getattr(PARENT, name)
        pkw, live = parent_kw(pw, ekw)
        out["parent_ms" + sfx] = time_ms(lambda: pw(*args, **pkw))
        fns.append(prepacked(PARENT, name, args, explain, kw, live=live))
        keys.append("parent_kernel_ms" + sfx)
        if name == "set_chunk":
            fns.append(prepacked(PARENT, name, args, explain, kw, live=True))
            keys.append("parent_live_kernel_ms" + sfx)
    if name not in ("sig_decide", "decide_grouped"):
        # the wrappers too, in turns with the parent's (explain off)
        ekw = {**kw, **({"explain": True} if explains[-1] else {})}
        fns.append(lambda: wrapper(*new_args, **ekw))
        keys.append("wrapper_steady_ms")
        if PARENT is not None:
            pw = getattr(PARENT, name)
            pkw, _ = parent_kw(pw, ekw)
            fns.append(lambda: pw(*args, **pkw))
            keys.append("parent_wrapper_steady_ms")
    out.update(zip(keys, time_steady(*fns)))
    return out


def time_kernel(name: str, args: tuple, plain_iters: int = 1) -> dict:
    """The kernel and its plain version on one call's arguments, CUDA
    events (the kernel: mean of ITERS launches through its wrapper after a
    warm-up; K3 and K4 also as ``redesigned_times`` reads them)."""
    launch = {"sig_decide": kmod.sig_decide,
              "decide_grouped": kmod.decide_grouped,
              "decide_dense": kmod.decide_dense}[name]
    extra = {}
    if name in REDESIGNED:
        extra = redesigned_times(name, args)
        ms = extra.pop("ms")
        extra["flags"] = [bool(f) for f in args[len(args) - N_FLAGS[name]:]]
    else:
        ms = time_ms(lambda: launch(*args))
    plain_ms = time_ms(lambda: PLAIN[name](*args), plain_iters)
    if name == "sig_decide":
        bms, by, nbytes, ops = bound_sig_decide(args)
    elif name == "decide_grouped":
        inv, cs, _, r, _, _, with_rel = args
        bms, by, nbytes, ops = bound_ms({**inv, **cs}, r, with_rel,
                                        every_pair=True)
    else:
        c, r, _, _, with_rel = args
        bms, by, nbytes, ops = bound_ms(c, r, with_rel)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bytes=nbytes, ops=ops, **extra)


def sig_tree(device, scoped: bool) -> tuple:
    """Phase 7's 100k-rule stress tree (``scoped``: role-scoped): (engine,
    evaluator, seconds to load and compile)."""
    t0 = time.perf_counter()
    engine = engine_from_doc(stress_doc(100_000, scoped=scoped))
    evaluator = HybridEvaluator(engine, device=device)
    return engine, evaluator, time.perf_counter() - t0


def phase_sig_main(device, stats: dict, card: str, trees: dict) -> dict:
    """Phase 7 and 8 for the signature paths (a), (b), (c); ``trees``
    holds ``sig_tree``'s two trees under "a" and "b"."""
    out = {}
    engine, evaluator, secs = trees.pop("a")
    compiled = evaluator._compiled
    log(f"  100k stress tree: {compiled.n_rules} rules, S={compiled.S} "
        f"KP={compiled.KP} KR={compiled.KR} T={compiled.T}, loaded and "
        f"compiled in {secs:.1f} s")
    if not evaluator._kernel.active:
        raise AssertionError("the 100k tree did not take the signature path")

    # (a) bench_stress traffic, 16,384 rows
    reqs = stress_traffic(16384)
    launches, a_args = run_main_path("(a) stress 16384", evaluator, engine,
                                     reqs, ("sig_planes", "sig_decide"),
                                     stats)
    kern = evaluator._kernel
    stack = next(reversed(kern._stacks.values()))
    tabs = stack.tables
    sig_args = a_args["sig_decide"]
    log(f"  (a) shapes: G={tabs['t_role'].shape[0]} Tp={tabs['t_role'].shape[1]}"
        f" KRp={tabs['rule_valid'].shape[3]} NSLOT={sig_args[5].shape[0]} "
        f"R={sig_args[5].shape[1]} row width={sig_args[4].shape[1]}")
    out["planes_args"] = {"a": a_args["sig_planes"]}
    out["a"] = {"launches": launches,
                "sig_decide": time_kernel("sig_decide", sig_args),
                "h2d_rows_ms": h2d_ms(sig_args[4])}
    out["a"]["steady"] = steady_state(evaluator, reqs)
    # the (a) evaluator serves phase 19's wire cell at (a)
    out["wire_a"] = (engine, evaluator, reqs)

    # (c) the same tree, a few ACL rows in 16,384: all through decide_grouped
    reqs_c = stress_traffic(16384, seed=8, n_acl=16)
    acl_rows = [i for i, r in enumerate(reqs_c) if r.context["resources"]]
    launches, c_args = run_main_path("(c) stress + ACL 16384", evaluator,
                                     engine, reqs_c, ("decide_grouped",),
                                     stats, always=acl_rows)
    if launches["sig_decide"]:
        raise AssertionError("(c): an ACL batch went through sig_decide")
    out["c"] = {"launches": launches,
                "decide_grouped": time_kernel("decide_grouped",
                                              c_args["decide_grouped"])}
    out["c_args"] = c_args["decide_grouped"]
    # the tree (host objects only) stays for phase 9's K5 check
    out["tree_100k"] = (engine, evaluator._compiled,
                        evaluator._tree_snapshot)
    del evaluator, engine, kern, stack, tabs, a_args, sig_args, c_args

    # (b) the scoped tree with bench_stress_hr traffic, 8,192 rows
    engine, evaluator, secs = trees.pop("b")
    if not evaluator._kernel.needs_hr:
        raise AssertionError("the scoped tree carries no HR targets")
    log(f"  100k scoped tree loaded and compiled in {secs:.1f} s")
    reqs_b = stress_hr_traffic(8192)
    launches, b_args = run_main_path("(b) stress HR 8192", evaluator, engine,
                                     reqs_b, ("sig_planes", "sig_decide"),
                                     stats)
    if not b_args["sig_decide"][-2]:
        raise AssertionError("(b): sig_decide ran without HR")
    out["planes_args"]["b"] = b_args["sig_planes"]
    out["b"] = {"launches": launches,
                "sig_decide": time_kernel("sig_decide", b_args["sig_decide"]),
                "steady": steady_state(evaluator, reqs_b)}
    for key in ("a", "b", "c"):
        log(f"  ({key}) on {card}: " + json.dumps(out[key]))
    return out


# ------------------------------------------------- whatIsAllowed (K5)


def rq_key(rq):
    """Comparable projection of a ReverseQuery: ids, structure, rules,
    obligations element by element, status (the JAX package's
    tests/test_reverse.rq_shape)."""
    return (
        [(ps.id, ps.combining_algorithm,
          [(p.id, p.effect, p.evaluation_cacheable, p.has_rules,
            [(r.id, r.effect, r.condition, r.evaluation_cacheable)
             for r in p.rules])
           for p in ps.policies])
         for ps in rq.policy_sets],
        [(o.id, o.value, [(n.id, n.value) for n in (o.attributes or [])])
         for o in rq.obligations],
        (rq.operation_status.code, rq.operation_status.message),
    )


class WiaCheck:
    """While active, every ``wia_planes`` call of ``ReverseQueryKernel``
    launches the kernel, then runs the plain version on the same device
    tensors; any difference raises.  Counts the calls and the largest
    error in ``stats``, and keeps each call's arguments, last first."""

    def __init__(self, stats: dict):
        self.stats = stats
        self.args: list[tuple] = []
        self._orig = None

    def __enter__(self):
        self._orig = rmod.wia_planes

        def checked(*args):
            got = self._orig(*args)
            want = reverse_ref.wia_planes_ref(*args)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            st = self.stats.setdefault("wia_planes",
                                       {"calls": 0, "max_abs_err": 0})
            st["calls"] += 1
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if err != 0:
                raise AssertionError(f"wia_planes: kernel != plain (max abs "
                                     f"err {err})")
            self.args.insert(0, args)
            return got

        rmod.wia_planes = checked
        return self

    def __exit__(self, *exc):
        rmod.wia_planes = self._orig
        return False


def wia_encode(requests, compiled):
    """The reverse query's encode (the evaluator's flags)."""
    return encode_requests(requests, compiled, skip_conditions=True,
                           skip_owner_bits=True, skip_relation_bits=True)


# the target-table columns the whatIsAllowed planes read (no plane reads
# the property gates, so the tails and property columns decide nothing)
WIA_READS = ("t_act_ids", "t_act_vals", "t_ent_vals", "t_ent_w",
             "t_op_vals", "t_has_props", "t_n_res")


def bound_wia_planes(args, t_rows=None) -> tuple[float, str, int, int]:
    """Bytes: the target-table columns the planes read (``WIA_READS``),
    the packed rows and the regex matrices read once, the [N, 7, T]
    planes written once.  Operations: stage A's compares per (row, target
    row), counted for this call's data: the target rows' valid action ids
    against the row's action slots, and per row its valid entity runs and
    operations (the kernel skips the empty slots).  ``t_rows``: the live
    target rows (``compiled_target_rows``; all when None) and with them
    the regex matrices' referenced vocab rows, the only ones counted."""
    tables, rows, schedule, rgx, pfx = args
    N, T = rows.shape[0], tables["t_n_res"].shape[0]
    if t_rows is not None:
        t_rows = t_rows.to(tables["t_n_res"].device)
        tables = {k: v[t_rows] for k, v in tables.items()}
        T = int(t_rows.numel())
        w = tables["t_ent_w"]
        W = max(int(torch.unique(w[w >= 0]).numel()), 1)
        rgx_bytes = (int(rgx.nbytes) + int(pfx.nbytes)) * W // rgx.shape[0]
    else:
        rgx_bytes = int(rgx.nbytes) + int(pfx.nbytes)
    nbytes = sum(int(tables[k].nbytes) for k in WIA_READS)
    nbytes += int(rows.nbytes) + rgx_bytes
    nbytes += N * len(reverse_ref.PLANE_KEYS) * T
    cols = prefilter_ref.unpack_rows(rows.cpu(), schedule)
    KE, KO = (tables[k].shape[1] for k in ("t_ent_vals", "t_op_vals"))
    NACT = cols["r_act_ids"].shape[1]
    runs = int((cols["r_ent_valid"] != 0).sum())
    ops_v = int((cols["r_op_vals"] >= 0).sum())
    act_ids = int((tables["t_act_ids"] >= 0).sum())
    ops = (N * act_ids * NACT + T * (3 * KE * runs + KO * ops_v)
           + N * T * 16)
    return _finish_bound(nbytes, ops)


def phase_wia_vs_plain(device, stats: dict, tree_100k) -> dict:
    """Phase 9: every ``wia_planes`` call of ``ReverseQueryKernel.evaluate``
    held against its plain version on the card: the fixture trees of the
    JAX package's reverse differential with grid traffic, the 1,000- and
    10,000-rule stress trees, and the 100k-rule stress tree with 256
    representative rows of ``bench_stress`` traffic (planes only).
    Returns the arguments of the 100k call for the timing phase."""
    fixtures = ["basic_policies.yml", "policy_targets.yml",
                "policy_set_targets.yml", "role_scopes.yml",
                "conditions.yml", "acl_policies.yml", "props_single.yml",
                "props_rules_noprop.yml", "props_multi_rules.yml",
                "props_multi_rules_entities.yml", "ops_multi.yml"]
    with WiaCheck(stats) as chk:
        for name in fixtures:
            engine = engine_for(name)
            compiled = compile_policies(engine.policy_sets, engine.urns)
            kern = rmod.ReverseQueryKernel(compiled, engine.policy_sets,
                                           device=device)
            reqs = grid_requests(random.Random(211), 100)
            kern.evaluate(wia_encode(reqs, compiled))
            log(f"  {name}: {len(kern._plane_cache)} signatures, planes "
                f"equal to the plain version")
        for n_rules, reqs in ((1000, wia_large_requests(2048)),
                              (10_000, lattice_requests(4096))):
            engine = engine_from_doc(stress_doc(n_rules))
            compiled = compile_policies(engine.policy_sets, engine.urns)
            kern = rmod.ReverseQueryKernel(compiled, engine.policy_sets,
                                           device=device)
            kern.evaluate(wia_encode(reqs, compiled))
            log(f"  stress {n_rules}: T={compiled.T}, "
                f"{len(kern._plane_cache)} signatures, planes equal")
        engine, compiled, tree = tree_100k
        reqs = [r for r in stress_traffic(4096)
                if r.target.resources[0].value in STRESS_ENTITIES]
        kern = rmod.ReverseQueryKernel(compiled, tree, copy_tree=False,
                                       device=device)
        batch = wia_encode(reqs, compiled)
        uniq, first_idx, _ = kern.signatures(batch)
        if len(first_idx) != 256:
            raise AssertionError(f"100k: {len(first_idx)} signatures, "
                                 f"want 256")
        t0 = time.perf_counter()
        kern._signature_planes(batch, uniq, first_idx)
        log(f"  stress 100k: T={compiled.T}, 256 representative rows, "
            f"planes equal ({time.perf_counter() - t0:.1f} s with the "
            f"plain version)")
        args_100k = chk.args[0]
    return {"100k": args_100k, "t_rows": compiled_target_rows(compiled)}


def lattice_requests(n: int) -> list:
    """The first ``n`` cells of the 128 x 128 x 1 lattice."""
    spec = LatticeSpec.stress(128, 128, ("read",))
    return [spec.request(i) for i in range(n)]


def phase_wia_main(device, stats: dict, card: str) -> dict:
    """Phase 10: ``HybridEvaluator.what_is_allowed_batch`` on
    ``wia-large`` (the 1,000-rule stress tree, 2,048 ``bench_wia_large``
    queries): one ``wia_planes`` launch on the first batch, none on warm
    ones; every response equal to ``engine.what_is_allowed``."""
    engine = engine_from_doc(stress_doc(1000))
    evaluator = HybridEvaluator(engine, device=device)
    compiled = evaluator._compiled
    if compiled.n_rules < rmod.REVERSE_MIN_RULES:
        raise AssertionError("wia-large is below REVERSE_MIN_RULES")
    reqs = wia_large_requests(2048)
    log(f"  wia-large: {compiled.n_rules} rules, S={compiled.S} "
        f"KP={compiled.KP} KR={compiled.KR} T={compiled.T}")
    reset_launches()
    with WiaCheck(stats) as chk:
        t0 = time.perf_counter()
        responses = evaluator.what_is_allowed_batch(clone(reqs))
        cold_s = time.perf_counter() - t0
    launches = dict(kmod.LAUNCHES)
    if launches["wia_planes"] != 1:
        raise AssertionError(f"wia-large first batch: launches {launches}")
    args = chk.args[0]
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        want = engine.what_is_allowed(clone(req))
        if rq_key(responses[i]) != rq_key(want):
            raise AssertionError(f"wia-large row {i} differs from the "
                                 f"oracle")
    oracle_all_s = time.perf_counter() - t0
    n_rules_matched = sum(len(p.rules) for r in responses
                          for ps in r.policy_sets for p in ps.policies)
    log(f"  wia-large first batch: 2048 responses equal to the oracle "
        f"({n_rules_matched} matched rules in all); launches {launches}; "
        f"K5 equal to its plain version; cold batch {cold_s * 1e3:.1f} ms")

    # warm batches: no kernel launch, mean of 3
    reset_launches()
    batches = [clone(reqs) for _ in range(3)]
    t0 = time.perf_counter()
    for b in batches:
        evaluator.what_is_allowed_batch(b)
    warm_s = (time.perf_counter() - t0) / 3
    if kmod.LAUNCHES["wia_planes"] != 0:
        raise AssertionError("wia-large warm batches launched wia_planes")

    # the stage split of one warm batch, each stage timed alone
    kern = evaluator._rq_kernel
    b = clone(reqs)
    t = [time.perf_counter()]
    batch = wia_encode(b, compiled)
    t.append(time.perf_counter())
    uniq, first_idx, inv = kern.signatures(batch)
    t.append(time.perf_counter())
    planes = kern._signature_planes(batch, uniq, first_idx)
    t.append(time.perf_counter())
    masks = kern.fold(batch, planes[inv])
    t.append(time.perf_counter())
    cubes = rmod._rule_match_cubes(compiled, masks, kern.live)
    t.append(time.perf_counter())
    rmod.assemble_batch(engine, compiled, kern, b, batch, masks, cubes)
    t.append(time.perf_counter())
    names = ("encode", "signature_unique", "plane_lookup", "subject_fold",
             "rule_match_cubes", "assembly")
    stages = {k: (t[i + 1] - t[i]) * 1e3 for i, k in enumerate(names)}
    # a cold miss set: pack + copy + K5 + readback, CUDA events
    fresh = rmod.ReverseQueryKernel(compiled, kern.sets, copy_tree=False,
                                    device=device)
    miss_ms = time_ms(lambda: fresh._launch_missing(batch, first_idx))

    t0 = time.perf_counter()
    for req in reqs[:128]:
        engine.what_is_allowed(clone(req))
    oracle_qps = 128 / (time.perf_counter() - t0)
    out = {
        "launches": launches, "args": args,
        "t_rows": compiled_target_rows(compiled),
        "queries_per_s": len(reqs) / warm_s, "batch_ms": warm_s * 1e3,
        "cold_batch_ms": cold_s * 1e3, "stages_ms": stages,
        "miss_set_ms": miss_ms, "signatures": int(len(first_idx)),
        "oracle_qps": oracle_qps, "oracle_all_s": oracle_all_s,
    }
    log(f"  wia-large on {card}: {out['queries_per_s']:.1f} queries/s "
        f"warm ({out['batch_ms']:.3f} ms per 2048), stages (ms) "
        f"{json.dumps(stages)}; cold miss set of {len(first_idx)} "
        f"signatures (pack, copy, K5, readback) {miss_ms:.3f} ms; scalar "
        f"oracle {oracle_qps:.1f} queries/s")
    return out


def phase_lattice(device, stats: dict, card: str) -> dict:
    """Phase 11: the direct-mode audit sweep of the 128 x 128 x 1 lattice
    over the 10,000-rule stress tree in 4,096-cell chunks: a warm sweep of
    its first 32 subjects (one chunk, every resource signature of the
    lattice), then a timed sweep of the whole lattice with zero
    ``wia_planes`` launches; the bitmap held against
    ``engine.is_allowed`` on a 256-cell strided sample."""
    import tempfile

    engine = engine_from_doc(stress_doc(10_000))
    evaluator = HybridEvaluator(engine, device=device)
    compiled = evaluator._compiled
    spec = LatticeSpec.stress(128, 128, ("read",))
    warm_spec = LatticeSpec.stress(32, 128, ("read",))
    log(f"  lattice: {spec.n_cells} cells, {compiled.n_rules} rules, "
        f"S={compiled.S} KP={compiled.KP} KR={compiled.KR} T={compiled.T}")
    with tempfile.TemporaryDirectory(prefix="acs-lattice-") as out_dir:
        manager = AuditSweepManager(evaluator, out_dir=out_dir,
                                    chunk_size=4096)
        try:
            reset_launches()
            with WiaCheck(stats) as chk:
                t0 = time.perf_counter()
                warm = manager.start_sweep(spec=warm_spec, wait=True,
                                           wait_timeout=900)
                warm_s = time.perf_counter() - t0
            warm_launches = kmod.LAUNCHES["wia_planes"]
            if warm.state != "done" or warm_launches < 1:
                raise AssertionError(f"warm sweep: {warm.status()}, "
                                     f"{warm_launches} wia_planes launches")
            args = chk.args[-1]
            reset_launches()
            t0 = time.perf_counter()
            job = manager.start_sweep(spec=spec, wait=True, wait_timeout=900)
            sweep_s = time.perf_counter() - t0
            timed_launches = kmod.LAUNCHES["wia_planes"]
            if job.state != "done":
                raise AssertionError(f"timed sweep: {job.status()}")
            if timed_launches != 0:
                raise AssertionError(f"the timed sweep launched wia_planes "
                                     f"{timed_launches} times")
            codes = load_bitmap(job.bitmap_path, spec.n_cells)
            summary = job.status()["summary"]
        finally:
            manager.stop()
    # the sample after the sweep threads stopped: the oracle walks fork
    stride = max(1, spec.n_cells // 256)
    sampled = list(range(0, spec.n_cells, stride))[:256]
    code_of = {"PERMIT": 1, "DENY": 2}
    cells = [spec.request(index) for index in sampled]
    t0 = time.perf_counter()
    walks = oracle_walks(engine, cells, range(len(cells)))
    oracle_s = time.perf_counter() - t0
    for index, resp in zip(sampled, walks):
        if codes[index] != code_of.get(resp.decision, 0):
            raise AssertionError(f"cell {index}: bitmap {codes[index]} vs "
                                 f"oracle {resp.decision}")
    out = {
        "cells": spec.n_cells, "sweep_s": sweep_s, "warm_sweep_s": warm_s,
        "cells_per_s": spec.n_cells / sweep_s,
        "oracle_cells_per_s": len(sampled) / oracle_s,
        "warm_launches": warm_launches, "timed_launches": timed_launches,
        "summary": summary, "args": args,
        "t_rows": compiled_target_rows(compiled),
    }
    log(f"  lattice on {card}: {out['cells_per_s']:.1f} cells/s timed "
        f"({sweep_s:.2f} s; warm sweep of {warm_spec.n_cells} cells "
        f"{warm_s:.2f} s with {warm_launches} "
        f"wia_planes launches, K5 equal to its plain version); timed sweep "
        f"wia_planes launches {timed_launches}; {len(sampled)} sampled "
        f"cells equal to the oracle ({out['oracle_cells_per_s']:.1f} "
        f"cells/s); summary {json.dumps(summary)}")
    return out


# ------------------------------------------------ ReBAC: trees and tuples


DOC = "urn:restorecommerce:acs:model:document.Document"
FOLDER = "urn:restorecommerce:acs:model:folder.Folder"
REL_PATHS = ("viewer", "owner", "parent.owner", "viewer|parent.owner",
             "owner!direct")


def relation_engine(path: str = "viewer") -> AccessController:
    """``tests/fixtures/relation_policies.yml`` (a relation-gated PERMIT
    rule on documents, then a DENY fallback) with its relation path
    replaced by ``path``."""
    with open(os.path.join(REPO, "tests", "fixtures",
                           "relation_policies.yml")) as fh:
        text = fh.read()
    return engine_from_doc(yaml.safe_load(
        text.replace("value: viewer", f"value: {path}")))


def tuple_store(*ops) -> RelationTupleStore:
    """A store after ``ops``, each (method name, arguments...)."""
    store = RelationTupleStore()
    for name, *args in ops:
        getattr(store, name)(*args)
    return store


def doc_requests(subjects, docs, **kw) -> list[Request]:
    """Reads of every subject on every document (a list of ids is one
    multi-resource row)."""
    return [build_request(
        subject_id=s, resource_type=[DOC] * len(d) if isinstance(d, list)
        else DOC, resource_id=d, action_type=URNS["read"], **kw)
        for s in subjects for d in docs]


def rel_fixture_cases() -> list[tuple]:
    """(label, engine, store or None, requests, encode options): the JAX
    package's ``tests/test_relations.py`` shapes: the three rewrite
    kinds, folder chains of depth 1-6, the kernel-variant tuples with
    plain, ACL and property rows, a batch encoded with
    ``skip_relation_bits`` and one without a store."""
    owner = ("set_rewrite", DOC, "viewer",
             [("this",), ("computed_userset", "owner")])
    subjects = ["alice", "bob", "carol", "mallory"]
    docs = ["doc1", "doc2", "doc3", ["doc1", "doc3"]]
    kinds = {
        "direct": (("create", [(DOC, "doc1", "viewer", "alice")]),),
        "computed_userset": (owner, ("create",
                                     [(DOC, "doc1", "owner", "alice")])),
        "tuple_to_userset": (
            ("set_rewrite", DOC, "viewer",
             [("this",), ("tuple_to_userset", "parent", "viewer")]),
            ("create", [(DOC, "doc1", "parent",
                         {"object": {"entity": FOLDER, "id": "f1"}}),
                        (FOLDER, "f1", "viewer", "alice")])),
    }
    cases = [(f"rewrite {k}", relation_engine(), tuple_store(*ops),
              doc_requests(subjects, docs), {}) for k, ops in kinds.items()]
    for depth in range(1, 7):
        path = ".".join(["parent"] * (depth - 1) + ["owner"])
        chain = [(DOC, "doc1", "owner", "alice")] if depth == 1 else [
            (DOC, "doc1", "parent", {"object": {"entity": FOLDER,
                                                "id": "f1"}})]
        if depth > 1:
            chain += [(FOLDER, f"f{i}", "parent",
                       {"object": {"entity": FOLDER, "id": f"f{i + 1}"}})
                      for i in range(1, depth - 1)]
            chain += [(FOLDER, f"f{depth - 1}", "owner", "alice"),
                      (DOC, "doc2", "parent",
                       {"object": {"entity": FOLDER, "id": f"f{depth - 1}"}})]
        cases.append((f"depth {depth}", relation_engine(path),
                       tuple_store(("create", chain)),
                       doc_requests(subjects, docs), {}))
    variants = tuple_store(owner, ("create", [
        (DOC, "doc1", "owner", "alice"), (DOC, "doc2", "viewer", "bob"),
        (DOC, "doc3", "viewer", {"object": {"entity": "group", "id": "g"},
                                 "relation": "member"}),
        ("group", "g", "member", "carol")]))
    cases += [
        ("variants", relation_engine(), variants,
         doc_requests(subjects, docs), {}),
        ("variants ACL", relation_engine(), variants,
         doc_requests(subjects, docs[:3]) + doc_requests(
             subjects[:2], docs[:1], acl_indicatory_entity=ORG,
             acl_instances=["Org1"]), {}),
        ("variants properties", relation_engine(), variants,
         doc_requests(subjects, docs[:3], resource_property=DOC + "#name"),
         {}),
        ("skip_relation_bits", relation_engine(), variants,
         doc_requests(subjects, docs), {"skip_relation_bits": True}),
        ("no store", relation_engine(), None, doc_requests(subjects, docs),
         {}),
    ]
    return cases


def rel_stress_doc(scoped: bool):
    """The 720-rule stress tree with a relation-path subject on three
    rules in four (the five path shapes of ``REL_PATHS`` in turn);
    ``scoped`` adds the roleScopingEntity to every rule, so the HR and
    the relation folds stack."""
    doc = small_stress_doc(scoped=scoped)
    for pol in doc["policy_sets"][0]["policies"]:
        for rule in pol["rules"]:
            rid = int(rule["id"][1:])
            if rid % 4 != 3:
                rule["target"]["subjects"].append(
                    {"id": URNS["relation"],
                     "value": REL_PATHS[rid % len(REL_PATHS)]})
    return doc


def rel_stress_store(seed: int = 3) -> RelationTupleStore:
    """Viewer and owner grants and parent links to owned folders on the
    stress entities' documents ``doc0``-``doc7``, users ``u0``-``u15``,
    and a viewer rewrite on one entity."""
    rng = random.Random(seed)
    users = [f"u{i}" for i in range(16)]
    tuples = []
    for ent in STRESS_ENTITIES[:16]:
        for d in range(8):
            if rng.random() < 0.5:
                tuples.append((ent, f"doc{d}", "viewer", rng.choice(users)))
            if rng.random() < 0.4:
                tuples.append((ent, f"doc{d}", "owner", rng.choice(users)))
            if rng.random() < 0.4:
                tuples.append((ent, f"doc{d}", "parent", {"object": {
                    "entity": FOLDER, "id": f"f{rng.randrange(4)}"}}))
    tuples += [(FOLDER, f"f{f}", "owner", rng.choice(users))
               for f in range(4)]
    return tuple_store(("set_rewrite", STRESS_ENTITIES[0], "viewer",
                        [("this",), ("computed_userset", "owner")]),
                       ("create", tuples))


def rel_stress_traffic(n: int, seed: int, scoped: bool, acl: bool = False
                       ) -> list[Request]:
    """Rows on the relation stress tree: roles of the tree, the 16
    entities, documents ``doc0``-``doc7``, users ``u0``-``u15``; scoped
    rows carry an Org1 role scope and owners; ``acl`` puts an ACL pair on
    every eighth row."""
    rng = random.Random(seed)
    actions = ACTIONS[:4]
    out = []
    for i in range(n):
        role = f"role-{rng.randrange(23)}"
        kw = {}
        if scoped:
            kw = dict(role_scoping_entity=ORG, role_scoping_instance="Org1",
                      owner_indicatory_entity=ORG,
                      owner_instance=rng.choice(OWNERS))
        if acl and i % 8 == 0:
            kw.update(acl_indicatory_entity=ORG,
                      acl_instances=[rng.choice(OWNERS[:4])])
        req = build_request(
            subject_id=f"u{rng.randrange(16)}", subject_role=role,
            resource_type=STRESS_ENTITIES[rng.randrange(16)],
            resource_id=f"doc{rng.randrange(8)}",
            action_type=rng.choice(actions), **kw)
        if not scoped:
            req.context["subject"]["role_associations"] = [
                {"role": role, "attributes": []}]
        out.append(req)
    return out


def oracle_rows(engine, store, requests, batch, out, rows=None) -> int:
    """Eligible rows (all, or those of ``rows``) of a kernel output
    against ``engine.is_allowed`` with ``store`` attached: (decision,
    cacheable, status)."""
    engine.relation_store = store
    host = [o.cpu().numpy() if isinstance(o, torch.Tensor) else o
            for o in out]
    idx = [i for i in (range(len(requests)) if rows is None else rows)
           if batch.eligible[i]]
    n = 0
    for i, resp in zip(idx, oracle_walks(engine, requests, idx)):
        cach = resp.evaluation_cacheable
        want = (DEC_CODE[resp.decision], -1 if cach is None else int(cach),
                resp.operation_status.code)
        got = tuple(int(h[i]) for h in host)
        if got != want:
            raise AssertionError(f"row {i}: kernel {got} != oracle {want}")
        n += 1
    return n


# ------------------------------------ ReBAC: relation variants vs plain


def phase_rel_vs_plain(device, stats: dict) -> dict:
    """Phase 12: every ``with_rel`` call of ``decide_dense``,
    ``sig_planes``, ``sig_decide`` and ``decide_grouped`` held exactly
    against its plain version on the same device tensors: the relation
    fixture's cases through ``DecisionKernel`` and a forced
    ``PrefilteredKernel``, then the 720-rule relation tree (unscoped and
    scoped, at or above ``MIN_RULES``, so the signature kernels run
    unforced) with plain and ACL batches.  Returns the arguments of the
    unscoped 720-rule calls for the timing phase and their launches."""
    with KernelCheck(stats, dense=True):
        for label, engine, store, reqs, kw in rel_fixture_cases():
            compiled = compile_policies(engine.policy_sets, engine.urns)
            tables = store.tables_for(compiled) if store else None
            batch = encode_requests(clone(reqs), compiled,
                                    relation_tables=tables, **kw)
            dense = kmod.DecisionKernel(compiled, device=device)
            forced = pfmod.PrefilteredKernel(compiled, device=device)
            forced.active, forced._dense = True, None
            out = dense.evaluate(batch)
            if not all(np.array_equal(a, b) for a, b in
                       zip(out, forced.evaluate(batch))):
                raise AssertionError(f"{label}: dense != signature path")
            n = (0 if kw.get("skip_relation_bits")
                 else oracle_rows(engine, store, reqs, batch, out))
            log(f"  {label}: {len(reqs)} rows, every kernel call equal to "
                f"its plain version, {n} rows equal to the oracle; "
                f"decisions {out[0].tolist()}")
    out = {}
    for scoped in (False, True):
        engine = engine_from_doc(rel_stress_doc(scoped))
        compiled = compile_policies(engine.policy_sets, engine.urns)
        if not compiled.supported or compiled.n_rules < pfmod.MIN_RULES:
            raise AssertionError("the relation stress tree is not on the "
                                 "signature path")
        store = rel_stress_store()
        tables = store.tables_for(compiled)
        kern = pfmod.PrefilteredKernel(compiled, device=device)
        dense = kmod.DecisionKernel(compiled, device=device)
        check: dict = {}
        for acl in (False, True):
            reqs = rel_stress_traffic(512, 17 + acl, scoped, acl)
            batch = encode_requests(clone(reqs), compiled,
                                    relation_tables=tables)
            reset_launches()
            with KernelCheck(check, dense=True) as chk:
                got = kern.evaluate(batch)
                want = dense.evaluate(batch)
            launches = dict(kmod.LAUNCHES)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("720 relation tree: dense != "
                                     "signature path")
            ran = ("decide_grouped",) if acl else ("sig_planes",
                                                   "sig_decide")
            if not all(launches[k] for k in ran + ("decide_dense",)):
                raise AssertionError(f"720 relation tree: launches "
                                     f"{launches}")
            n = oracle_rows(engine, store, reqs, batch, got,
                            rows=range(0, 512, 8))
            permits = int((got[0][batch.eligible] == 1).sum())
            label = f"720 relation{' HR' if scoped else ''}" \
                f"{' ACL' if acl else ''}"
            log(f"  {label}: 512 rows, launches {launches}, every call "
                f"equal to its plain version; {n} sampled rows equal to "
                f"the oracle; {permits} PERMIT")
            if not scoped:
                out["launches_acl" if acl else "launches"] = launches
                out.update({k: v for k, v in chk.args.items()
                            if k != "decide_dense"})
        for k, v in check.items():
            st = stats.setdefault(k, {"calls": 0, "max_abs_err": 0,
                                      "variants": set()})
            st["calls"] += v["calls"]
            st["max_abs_err"] = max(st["max_abs_err"], v["max_abs_err"])
            st["variants"] |= v["variants"]
    want = {
        "decide_dense": {(a, h, True) for a in (False, True)
                         for h in (False, True)},
        "decide_grouped": {(True, False, True), (False, False, True),
                           (True, True, True)},
        "sig_planes": {(False, True), (True, True)},
        "sig_decide": {(False, True), (True, True)},
    }
    for name, variants in want.items():
        if not variants <= stats.get(name, {}).get("variants", set()):
            raise AssertionError(f"phase 12: {name} ran the variants "
                                 f"{sorted(stats[name]['variants'])}")
    log("  variants run (with_rel last): " + json.dumps(
        {k: sorted(stats[k]["variants"]) for k in want}))
    return out


# ------------------------------------------ ReBAC: the rebac-serve path


def rebac_setup(n_tuples: int, n_objects: int, depth: int):
    """The JAX package's ``rebac-serve`` configuration
    (``bench_all._rebac_setup``, copied): the relation fixture with the
    path ``viewer|parent...owner`` (``depth - 1`` parent hops), documents
    behind folder chains (64 documents per chain, ``depth - 1`` folders,
    the last one owned by ``chain-owner-{c % 512}``), the rest of the
    tuple budget as direct viewer grants.  Returns (engine, store, tuple
    count)."""
    path = "viewer|" + ".".join(["parent"] * (depth - 1) + ["owner"])
    engine = relation_engine(path)
    n_chains = max(1, n_objects // 64)
    tuples: list[tuple] = []
    for c in range(n_chains):
        for h in range(depth - 2):
            tuples.append((FOLDER, f"f{c}_{h}", "parent",
                           {"object": {"entity": FOLDER,
                                       "id": f"f{c}_{h + 1}"}}))
        tuples.append((FOLDER, f"f{c}_{max(depth - 2, 0)}", "owner",
                       f"chain-owner-{c % 512}"))
    for i in range(n_objects):
        tuples.append((DOC, f"doc{i}", "parent",
                       {"object": {"entity": FOLDER,
                                   "id": f"f{i % n_chains}_0"}}))
    i = 0
    while len(tuples) < n_tuples:
        tuples.append((DOC, f"doc{i % n_objects}", "viewer",
                       f"viewer-{i % 4096}"))
        i += 1
    store = RelationTupleStore()
    store.create(tuples)
    return engine, store, len(tuples)


def rebac_request(subject: str, doc_id: str) -> Request:
    return Request(
        target=Target(
            subjects=[Attribute(id=URNS["role"], value="member"),
                      Attribute(id=URNS["subjectID"], value=subject)],
            resources=[Attribute(id=URNS["entity"], value=DOC),
                       Attribute(id=URNS["resourceID"], value=doc_id)],
            actions=[Attribute(id=URNS["actionID"], value=URNS["read"])],
        ),
        context={"resources": [],
                 "subject": {"id": subject, "role_associations": [],
                             "hierarchical_scopes": []}},
    )


def rebac_requests(n_objects: int, batch: int) -> list[Request]:
    """The ``rebac-serve`` traffic (``bench_all._rebac_requests``,
    copied): 45% direct viewer hits, 35% chain-owner hits, 20% misses,
    numpy seed 11."""
    n_chains = max(1, n_objects // 64)
    rng = np.random.default_rng(11)
    out = []
    for i in range(batch):
        draw = rng.random()
        rid_idx = int(rng.integers(n_objects))
        if draw < 0.45:
            k = int(rng.integers(6))
            subject = f"viewer-{(rid_idx + k * n_objects) % 4096}"
        elif draw < 0.8:
            subject = f"chain-owner-{(rid_idx % n_chains) % 512}"
        else:
            subject = f"stranger-{i}"
        out.append(rebac_request(subject, f"doc{rid_idx}"))
    return out


def rebac_tree(device, n_tuples: int = REBAC_TUPLES,
               n_objects: int = 100_000, depth: int = 4) -> dict:
    """Phase 13's host work: the tuple store, the evaluator and the
    closure fold, each timed."""
    t0 = time.perf_counter()
    engine, store, n = rebac_setup(n_tuples, n_objects, depth)
    setup_s = time.perf_counter() - t0
    evaluator = HybridEvaluator(engine, device=device)
    t0 = time.perf_counter()
    tables = store.tables_for(evaluator._compiled)
    return {"engine": engine, "store": store, "n": n, "setup_s": setup_s,
            "evaluator": evaluator, "tables": tables,
            "fold_s": time.perf_counter() - t0, "n_objects": n_objects,
            "depth": depth}


def phase_rebac(device, stats: dict, card: str, pre: dict,
                batch_rows: int = 4096) -> dict:
    """Phase 13: the ``rebac-serve`` main path.  The store attached to
    ``HybridEvaluator``; the first batch with every ``decide_dense`` call
    held against its plain version and every response against the
    oracle; warm decisions/s and the stage split; K1's relation variant
    beside the same kernel on the batch encoded with
    ``skip_relation_bits``; then a tuple create and delete that flip a
    probe's decision with no new build, no ``sig_planes`` launch and an
    unchanged compiled version."""
    engine, store, n, setup_s, evaluator, tables, fold_s, n_objects, \
        depth = (pre[k] for k in ("engine", "store", "n", "setup_s",
                                  "evaluator", "tables", "fold_s",
                                  "n_objects", "depth"))
    compiled = evaluator._compiled
    kern = evaluator._kernel
    if kern.active or not kern._dense.with_rel:
        raise AssertionError("rebac-serve: not the dense relation variant")
    evaluator.attach_relation_store(store)
    log(f"  rebac-serve: {n} tuples, {n_objects} documents, depth {depth}; "
        f"store built in {setup_s:.1f} s, closure fold {fold_s:.2f} s "
        f"({len(tables['obj_keys'])} objects, {len(tables['pairs'])} "
        f"pairs); {compiled.n_rules} rules, T={compiled.T}")
    reqs = rebac_requests(n_objects, batch_rows)

    check: dict = {}
    reset_launches()
    with KernelCheck(check, dense=True):
        responses = evaluator.is_allowed_batch(clone(reqs))
    launches = dict(kmod.LAUNCHES)
    if launches["decide_dense"] < 1:
        raise AssertionError("rebac-serve launched no decide_dense")
    st = stats.setdefault("decide_dense", {"calls": 0, "max_abs_err": 0,
                                           "variants": set()})
    st["max_abs_err"] = max(st["max_abs_err"],
                            check["decide_dense"]["max_abs_err"])
    if check["decide_dense"]["variants"] != {(False, False, True)}:
        raise AssertionError(f"rebac-serve ran {check['decide_dense']}")
    t0 = time.perf_counter()
    wants = oracle_walks(engine, reqs, range(len(reqs)))
    for i, want in enumerate(wants):
        if response_key(responses[i]) != response_key(want):
            raise AssertionError(f"rebac-serve row {i}: "
                                 f"{response_key(responses[i])} != "
                                 f"{response_key(want)}")
    oracle_s = time.perf_counter() - t0
    decisions: dict = {}
    for resp in responses:
        decisions[resp.decision] = decisions.get(resp.decision, 0) + 1
    if not decisions.get("PERMIT"):
        raise AssertionError("rebac-serve: no relation-decided PERMIT")
    log(f"  first batch: {batch_rows} responses equal to the oracle "
        f"({oracle_s:.1f} s for the oracle walk); launches {launches}; "
        f"decide_dense equal to its plain version; decisions {decisions} "
        f"(every PERMIT relation-decided: the tree's only PERMIT rule is "
        f"the relation rule)")

    warm = [clone(reqs) for _ in range(3)]
    evaluator.is_allowed_batch(clone(reqs))
    t0 = time.perf_counter()
    for b in warm:
        evaluator.is_allowed_batch(b)
    batch_s = (time.perf_counter() - t0) / len(warm)

    # the stage split of one warm batch, each stage timed alone
    b = clone(reqs)
    t = [time.perf_counter()]
    tables = evaluator._relation_tables(compiled)
    t.append(time.perf_counter())
    batch = encode_requests(b, compiled, engine.resource_adapter,
                            relation_tables=tables)
    t.append(time.perf_counter())
    thunk = kern.evaluate_async(batch)
    out = thunk()
    t.append(time.perf_counter())
    evaluator._decode_batch(b, batch, out)
    t.append(time.perf_counter())
    stages = {k: (t[i + 1] - t[i]) * 1e3 for i, k in enumerate(
        ("fold_cached", "encode", "device", "decode"))}
    t0 = time.perf_counter()
    pack_relation_bitplanes(batch.arrays, compiled, tables)
    stages["of_encode_pack_relation_bitplanes"] = \
        (time.perf_counter() - t0) * 1e3

    # K1's relation variant on this batch beside the same program on the
    # batch encoded with skip_relation_bits (1-wide dummy planes)
    _, r = batch_from_numpy(batch, device, keys=kmod.ROW_ARRAYS)
    flags = (False, False, True)
    args = (kern._dense._c, r) + flags
    k1 = time_kernel("decide_dense", args, plain_iters=2)
    skip = encode_requests(clone(reqs), compiled,
                           skip_relation_bits=True)
    _, r_skip = batch_from_numpy(skip, device, keys=kmod.ROW_ARRAYS)
    got, want = kernel_vs_plain(kern._dense._c, r_skip, flags)
    if not torch.equal(got, want):
        raise AssertionError("rebac-serve skip batch: kernel != plain")
    # in turns (relation, dummy, dummy, relation), one card, one call
    turns = [time_ms(lambda rr=rr: kmod.decide_dense(kern._dense._c, rr,
                                                     *flags))
             for rr in (r, r_skip, r_skip, r)]
    rel_ms, skip_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    k1.update(turns_ms=turns, skip_relation_bits_ms=skip_ms,
              overhead_pct=(rel_ms / skip_ms - 1.0) * 100.0,
              launches=launches["decide_dense"], rows=int(r["r_n_ra"].shape[0]),
              NRU_REL=int(r["r_rel_runs"].shape[1]))

    # tuple churn: a grant created and deleted flips the probe; nothing
    # is rebuilt, compiled or launched beyond the dense kernel
    probe = rebac_request("churn-probe-user", "doc0")
    grant = [(DOC, "doc0", "viewer", "churn-probe-user")]
    built = sorted(os.listdir(cuda_build.BUILD_DIR))
    libs = sorted(cuda_build._libs)
    version = compiled.version
    reset_launches()
    seen, ttv_ms = [], []
    for op in (None, "create", "delete"):
        t0 = time.perf_counter()
        if op is not None:
            getattr(store, op)(grant)
        resp = evaluator.is_allowed_batch([clone(probe)])[0]
        if op is not None:
            ttv_ms.append((time.perf_counter() - t0) * 1e3)
        want = engine.is_allowed(clone(probe))
        if response_key(resp) != response_key(want):
            raise AssertionError(f"churn {op}: {response_key(resp)} != "
                                 f"{response_key(want)}")
        seen.append(resp.decision)
    churn_launches = dict(kmod.LAUNCHES)
    if seen != ["DENY", "PERMIT", "DENY"]:
        raise AssertionError(f"churn decisions {seen}")
    if (sorted(os.listdir(cuda_build.BUILD_DIR)) != built
            or sorted(cuda_build._libs) != libs
            or evaluator._compiled.version != version
            or evaluator._kernel is not kern
            or churn_launches["sig_planes"] != 0
            or churn_launches["decide_dense"] != 3
            or evaluator.relation_churn != 2):
        raise AssertionError(f"churn swapped something: launches "
                             f"{churn_launches}, version "
                             f"{evaluator._compiled.version} vs {version}")
    out = {
        "tuples": n, "objects": n_objects, "depth": depth,
        "rows": batch_rows, "setup_s": setup_s, "fold_s": fold_s,
        "decisions_per_s": batch_rows / batch_s, "batch_ms": batch_s * 1e3,
        "stages_ms": stages, "decisions": decisions, "launches": launches,
        "k1": k1, "churn": {"decisions": seen, "ttv_ms": ttv_ms,
                            "launches": churn_launches},
        "k1_args": args,
    }
    log(f"  rebac-serve on {card}: {out['decisions_per_s']:.0f} decisions/s "
        f"warm ({out['batch_ms']:.3f} ms per {batch_rows}), stages (ms) "
        f"{json.dumps(stages)}")
    log(f"  decide_dense with_rel on {card}: "
        + json.dumps({k: v for k, v in k1.items() if k != "flags"}))
    log(f"  churn: decisions {seen}, time to visibility {ttv_ms} ms, "
        f"launches {churn_launches}, no new build, compiled version "
        f"{version} unchanged")
    return out


# ------------------------------------------- multi-device kernels (K6-K8)

# the JAX package's bench_shard_scale configuration: data/seed_data plus
# the 8,000-rule stress set, 2,048 wide rows drawn at numpy seed 23
SHARD_RULES = 8000
SHARD_ROWS = 2048
SHARD_SEED = 23
# the JAX program K6 runs (the dense kernel with the batch over data)
K6_REPLACES = "access_control_srv_tpu/parallel/mesh.py:97"
# the pod-sharded tail shard_tail also replaces (its rule-sharded tail is
# REPLACES["shard_tail"])
TAIL_ALSO_REPLACES = "access_control_srv_tpu/parallel/pod_shard.py:230"


def shard_scale_engine() -> AccessController:
    """The shard-scale tree: the seed data's policy set, then the
    8,000-rule stress set (two sets)."""
    engine = engine_for("seed_data")
    for ps in load_policy_sets(stress_doc(SHARD_RULES)):
        engine.update_policy_set(ps)
    return engine


def shard_scale_traffic(n_acl: int = 0) -> list[Request]:
    """The shard-scale rows: the JAX package's wide serving rows
    (``_serving_batch_msg(wide=True)``), which draw role and entity as
    ``bench_stress`` traffic does."""
    return stress_traffic(SHARD_ROWS, seed=SHARD_SEED, n_acl=n_acl)


def shard_flags(compiled, batch) -> tuple:
    return (bool((batch.arrays["r_acl_ent"] >= 0).any()),
            kmod.tree_needs_hr(compiled.arrays),
            kmod.tree_needs_rel(compiled.arrays))


def _checked(name: str, stats: dict, got, want) -> None:
    torch.cuda.synchronize()
    err = _max_err(got, want)
    st = stats.setdefault(name, {"calls": 0, "max_abs_err": 0})
    st["calls"] += 1
    st["max_abs_err"] = max(st["max_abs_err"], err)
    if err != 0:
        raise AssertionError(f"{name}: kernel != plain (max abs err {err})")


def bound_chunk(c, r, flags, out, every_pair: bool = False
                ) -> tuple[float, str, int, int]:
    """A shard kernel's bound: the dense bound's inputs and operations at
    the shard's shapes, with its merge rows as the output."""
    _, _, nbytes, ops = bound_ms(c, r, flags[2], every_pair)
    return _finish_bound(nbytes - 12 * int(r["r_n_ra"].shape[0])
                         + int(out.nbytes), ops)


def bound_tail(merge, tabs, out) -> tuple[float, str, int, int]:
    """The tail's bound: the merge rows and tables read once, three int32
    written per row; per (set, policy) about 16 integer operations (the
    selection, the no-rules test, the combination), per abort slot two."""
    nbytes = int(merge.nbytes) + int(out.nbytes)
    B = int(merge.shape[0])
    per_row = 8
    if tabs is not None:
        nbytes += sum(int(t.nbytes) for t in tabs.values())
        S, KP = tabs["pol_ca"].shape
        per_row += 16 * S * KP
    return _finish_bound(nbytes, B * per_row)


def to_kr_stride(code: torch.Tensor, KR: int, kr_total: int
                 ) -> torch.Tensor:
    """Provenance codes in strides (KP, KR) re-based to the rule-sharded
    strides (KP, kr_total): rule and abort positions move, no-rules
    policy positions do not."""
    kind, pos = code & 3, code >> 2
    rebased = ((pos // KR * kr_total + pos % KR) << 2) | kind
    return torch.where((kind == 1) | (kind == 3), rebased, code)


def check_sharded(label: str, compiled, batch, device, n_model: int,
                  want, stats: dict, explain: bool = False) -> None:
    """Every shard of an ``n_model``-way rule partition and set partition
    of ``compiled``: each shard kernel and the tail held against their
    plain versions on the same device tensors (exactly equal), the
    shards' merge rows merged with ``amin`` (what the MIN all_reduce
    computes), and the tail's decisions equal to ``want`` (int32 [3, B],
    the single-device kernel's) on every eligible row.  With ``explain``
    the explain variants (``set_chunk``'s provenance column, both tails'
    fourth output) and ``want`` [4, B]: K8's codes equal the single
    device's, K7's once re-based to ``kr_total``."""
    flags = shard_flags(compiled, batch)
    _, r = mmod.row_slice(batch, device, kmod.ROW_ARRAYS, 1, 0)
    el = torch.from_numpy(np.asarray(batch.eligible)).to(device)
    n = batch.B

    part = rule_shard.partition_rules(compiled, n_model)
    kr_total = part.kr_local * n_model
    merges = []
    for d in range(n_model):
        cd = tables_from_numpy({k: part.arrays[k][d]
                                for k in kmod.TABLE_ARRAYS}, device)
        args = (cd, r, int(part.kr_offsets[d]), kr_total, n_model, d, *flags)
        got = kmod.rule_chunk(*args)
        _checked("rule_chunk", stats, got, shard_ref.rule_chunk_ref(*args))
        merges.append(got)
    merged = torch.stack(merges).amin(dim=0)
    tabs = tables_from_numpy(compiled.arrays, device, keys=kmod.TAIL_TABLES)
    tail7 = {"explain": explain, "kr_stride": kr_total} if explain else {}
    out7 = kmod.shard_tail(merged, n_model, tabs, **tail7)
    tag = "+explain" if explain else ""
    _checked("shard_tail" + tag, stats, out7,
             shard_ref.shard_tail_ref(merged, n_model, tabs, **tail7))

    shards, s_local = pod_shard.partition_sets(compiled, n_model)
    merges = []
    kw = {"explain": True} if explain else {}
    for d, sh in enumerate(shards):
        cd = tables_from_numpy({k: sh.arrays[k] for k in kmod.TABLE_ARRAYS},
                               device)
        args = (cd, r, sh.s_lo, n_model, d, *flags)
        got = kmod.set_chunk(*args, **kw)
        _checked("set_chunk" + tag, stats, got,
                 shard_ref.set_chunk_ref(*args, **kw))
        merges.append(got)
    merged = torch.stack(merges).amin(dim=0)
    tail8 = {"explain": explain, "kr_stride": compiled.KR} if explain else {}
    out8 = kmod.shard_tail(merged, n_model, **tail8)
    _checked("shard_tail" + tag, stats, out8,
             shard_ref.shard_tail_ref(merged, n_model, **tail8))

    want7 = want
    if explain:
        want7 = torch.cat([want[:3], to_kr_stride(want[3:], compiled.KR,
                                                  kr_total)])
    for tag, out, w in (("rule-sharded", out7, want7),
                        ("pod-sharded", out8, want)):
        if not torch.equal(out[:, :n][:, el], w[:, el]):
            raise AssertionError(f"{label}: {tag} outputs differ from "
                                 f"PrefilteredKernel's")
    log(f"  {label}: {n} rows, {n_model} rule shards (KR_local "
        f"{part.kr_local}) and {n_model} set shards (S_local {s_local}): "
        f"every {'explain ' if explain else ''}kernel equal to its plain "
        f"version, merged outputs equal to PrefilteredKernel's on "
        f"{int(el.sum())} eligible rows")


def single_device_out(compiled, batch, device, explain: bool = False
                      ) -> torch.Tensor:
    out = pfmod.PrefilteredKernel(compiled, device=device,
                                  explain=explain).evaluate(batch)
    return torch.from_numpy(np.stack(out)).to(device)


def phase_shard_vs_plain(device, stats: dict, tree_100k) -> None:
    """Phase 14: every shard of a 4-way rule and set partition of the
    shard-scale tree (2,048 rows), the 100k stress tree (1,024 rows of
    ``bench_stress`` traffic; KR_local 100) and every fixture tree (grid
    traffic) through ``rule_chunk`` / ``set_chunk`` / ``shard_tail``
    against their plain versions; merged decisions equal to the
    single-device ``PrefilteredKernel``'s.  (The kernels' times come from
    phase 15, on the arguments the main path gives them.)"""
    t0 = time.perf_counter()
    engine = shard_scale_engine()
    compiled = compile_policies(engine.policy_sets, engine.urns)
    log(f"  shard-scale tree: {compiled.n_rules} rules, S={compiled.S} "
        f"KP={compiled.KP} KR={compiled.KR} T={compiled.T} "
        f"({time.perf_counter() - t0:.1f} s)")
    batch = encode_requests(shard_scale_traffic(), compiled)
    want = single_device_out(compiled, batch, device)
    check_sharded("shard-scale", compiled, batch, device, 4, want, stats)

    _, compiled_100k, _ = tree_100k
    batch = encode_requests(stress_traffic(1024, seed=11), compiled_100k)
    want = single_device_out(compiled_100k, batch, device)
    check_sharded("100k stress", compiled_100k, batch, device, 4, want,
                  stats)

    rng = random.Random(14)
    for name in tree_names():
        eng = engine_for(name)
        comp = compile_policies(eng.policy_sets, eng.urns)
        if not comp.supported or comp.n_rules == 0:
            continue
        batch = encode_requests(grid_requests(rng, 256), comp)
        want = single_device_out(comp, batch, device)
        check_sharded(name, comp, batch, device, 4, want, stats)


def _reset_counts() -> None:
    reset_launches()
    for k in mmod.COLLECTIVES:
        mmod.COLLECTIVES[k] = 0


def _host_ms(fn, iters: int = ITERS) -> float:
    """Host-clock milliseconds per call, each ending in a device sync (a
    collective's time: gloo runs on the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def layout_stage_times(kernel, calls: dict, check: dict,
                       kw_of: dict) -> dict:
    """One rank's stage times for a sharded kernel on the arguments its
    main-path batch gave each kernel (``KernelCheck.calls``): per kernel
    the batch's launches and their plain versions (CUDA events, summed
    over the batch's calls), the bound from those inputs and the largest
    difference the check saw (``kernels``), timed while the other ranks
    wait at a barrier, so no other rank's kernel shares the card; then
    the MIN all_reduce over model and the all-gather over data (host
    clock: gloo stages through the host).  Every rank runs the same
    calls, so the collectives pair up."""
    import torch.distributed as dist

    mesh = kernel.mesh
    if isinstance(kernel, rule_shard.RuleShardedKernel):
        names, model_axis = ("rule_chunk", "shard_tail"), kernel.model_axis
    elif isinstance(kernel, pod_shard.PodShardedKernel):
        names, model_axis = ("set_chunk", "shard_tail"), kernel.model_axis
    else:  # ShardedDecisionKernel
        names, model_axis = ("decide_dense",), None
    if kernel.explain:  # the explain variants' calls (rule_chunk has none)
        names = tuple(n if n == "rule_chunk" else n + "+explain"
                      for n in names)
    data_axis = kernel.axis if model_axis is None else kernel.data_axis
    out: dict = {"kernels": {}}

    def bound(key: str, a: tuple, every_pair: bool = False) -> tuple:
        """The call's bound (set_chunk: over the live target rows), or
        with ``every_pair`` the yardstick of the design before (the
        stage-A fold on every pair of the whole table)."""
        name, kw = key.split("+")[0], kw_of[key]
        res = getattr(kmod, name)(*a, **kw)
        if name == "decide_dense":
            return bound_ms(a[0], a[1], a[-1], every_pair)
        if name == "shard_tail":
            return bound_tail(a[0], a[2] if len(a) > 2 else None, res)
        # set_chunk's yardstick over the kernel's whole padded table
        c = kernel._c if every_pair else shard_ref.live_rows(
            a[0], kw.get("t_live"))
        return bound_chunk(c, a[1], a[-3:], res, every_pair)

    def timed(key: str) -> None:
        name, kw = key.split("+")[0], kw_of[key]
        launch = getattr(kmod, name)
        bounds = [bound(key, a) for a in calls[key]]
        live = {}
        if name in ("decide_dense", "set_chunk"):
            live["yardstick_ms"] = sum(bound(key, a, True)[0]
                                       for a in calls[key])
        out["kernels"][key] = {
            "ms": sum(time_ms(lambda a=a: launch(*a, **kw))
                      for a in calls[key]),
            "plain_ms": sum(time_ms(lambda a=a: PLAIN[name](*a, **kw), 1)
                            for a in calls[key]),
            "bound_ms": sum(b[0] for b in bounds),
            "bound_by": max(bounds)[1],
            "max_abs_err": check[name]["max_abs_err"],
            "launches": len(calls[key]),
            **live,
            "rows": [int(a[0].shape[0] if name == "shard_tail"
                         else a[1]["r_n_ra"].shape[0]) for a in calls[key]]}

    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn == dist.get_rank():
            for name in names:
                timed(name)
    dist.barrier()
    if model_axis is not None:
        first = names[0].split("+")[0]
        merge = getattr(kmod, first)(*calls[names[0]][-1],
                                     **kw_of[names[0]])
        torch.cuda.synchronize()
        out["merge_bytes"] = int(merge.nbytes)
        out["all_reduce_ms"] = _host_ms(
            lambda: mmod.all_reduce(merge.clone(), mesh, model_axis))
    res = getattr(kmod, names[-1].split("+")[0])(*calls[names[-1]][-1],
                                                 **kw_of[names[-1]])
    out["gather_ms"] = _host_ms(
        lambda: mmod.all_gather_cols(res, mesh, data_axis))
    return out


def _victim_probe(engine):
    """A stress rule whose effect flip changes the decision of the request
    built from its own target: (rule, probe request, decision before,
    decision after), the engine left flipped."""
    stress = engine.policy_sets["stress"]
    for pol in stress.combinables.values():
        for rule in pol.combinables.values():
            t = rule.target
            role = next(a.value for a in t.subjects if a.id == URNS["role"])
            probe = Request(
                target=Target(
                    subjects=[Attribute(id=URNS["role"], value=role),
                              Attribute(id=URNS["subjectID"], value="u0")],
                    resources=list(t.resources) + [
                        Attribute(id=URNS["resourceID"], value="res-0")],
                    actions=list(t.actions)),
                context={"resources": [], "subject": {
                    "id": "u0",
                    "role_associations": [{"role": role, "attributes": []}],
                    "hierarchical_scopes": []}})
            before = engine.is_allowed(clone(probe)).decision
            rule.effect = "DENY" if rule.effect == "PERMIT" else "PERMIT"
            after = engine.is_allowed(clone(probe)).decision
            if after != before:
                return rule, probe, before, after
            rule.effect = "DENY" if rule.effect == "PERMIT" else "PERMIT"
    raise AssertionError("no stress rule flips its own probe")


def built_state() -> tuple:
    """What this process has built and loaded, and the libraries on disk."""
    on_disk = (sorted(os.listdir(cuda_build.BUILD_DIR))
               if os.path.isdir(cuda_build.BUILD_DIR) else [])
    return set(cuda_build.BUILD_LOG), set(cuda_build._libs), on_disk


def delta_moved(before: dict, after: dict) -> dict:
    """What moved in ``delta_stats()`` between two reads: the counts
    (patches, noops, fallbacks, full compiles) and the fallback reasons."""
    keys = ("patches", "noops", "fallbacks", "full_compiles",
            "recompiles_avoided")
    moved = {k: after[k] - before[k] for k in keys if after[k] != before[k]}
    reasons = {k: v - before["fallback_reasons"].get(k, 0)
               for k, v in after["fallback_reasons"].items()
               if v != before["fallback_reasons"].get(k, 0)}
    if reasons:
        moved["reasons"] = reasons
    return moved


def pod_patch_check(engine, ev, device, reqs, rank: int) -> dict:
    """One in-capacity rule flip through the pod evaluator's
    ``refresh(events=...)`` (the delta patcher, then
    ``PodShardedKernel.patched``): exactly one patch counted, exactly one
    shard re-sliced (its fingerprint and applied-patch count move, the
    others are reused by reference), no library built; then one batch
    with every ``set_chunk`` / ``shard_tail`` call held against its plain
    version, its responses (the probe's among them) equal to a
    single-device evaluator's on the flipped tree, the probe's to the
    oracle's."""
    from access_control_srv_tpu_torch.ops.delta import CrudEvent

    rule, probe, before, after = _victim_probe(engine)
    try:
        old = "DENY" if rule.effect == "PERMIT" else "PERMIT"
        event = CrudEvent("rule", "update", rule.id,
                          {"id": rule.id, "effect": old},
                          {"id": rule.id, "effect": rule.effect})
        kernel0 = ev._kernel
        ident0, stats0, built = ev.shard_identity(), ev.delta_stats(), \
            built_state()
        t0 = time.perf_counter()
        ev.refresh(events=[event], wait=True)
        ttv_ms = (time.perf_counter() - t0) * 1e3
        moved = delta_moved(stats0, ev.delta_stats())
        if moved != {"patches": 1, "recompiles_avoided": 1}:
            raise AssertionError(f"pod patch: delta_stats moved {moved}")
        ident1 = ev.shard_identity()
        changed = [i for i, (a, b) in enumerate(zip(ident0["shards"],
                                                    ident1["shards"]))
                   if a["fingerprint"] != b["fingerprint"]]
        applied = [b["applied_patches"] - a["applied_patches"]
                   for a, b in zip(ident0["shards"], ident1["shards"])]
        reused = [a is b for a, b in zip(kernel0.shards, ev._kernel.shards)]
        if len(changed) != 1 or applied != [int(i in changed) for i in
                                            range(len(applied))] \
                or sum(reused) != len(reused) - 1:
            raise AssertionError(f"pod patch re-sliced shards {changed}, "
                                 f"applied {applied}")
        batch = clone(reqs) + [clone(probe)]
        single = HybridEvaluator(engine, device=device)
        want = [response_key(x) for x in
                single.is_allowed_batch(clone(batch))]
        del single
        check: dict = {}
        _reset_counts()
        with KernelCheck(check, names=("set_chunk", "shard_tail")):
            got = ev.is_allowed_batch(batch)
        launches = {k: v for k, v in kmod.LAUNCHES.items() if v}
        if launches.get("set_chunk", 0) < 1:
            raise AssertionError("pod patch: no set_chunk launch")
        bad = [i for i, g in enumerate(got) if response_key(g) != want[i]]
        if bad:
            raise AssertionError(f"pod patch rank {rank}: rows {bad[:8]} "
                                 "differ from the single device")
        if got[-1].decision != after:
            raise AssertionError(f"pod patch: probe {got[-1].decision}, "
                                 f"oracle {after}")
        if built != built_state():
            raise AssertionError("the pod patch built a library")
    finally:
        rule.effect = "DENY" if rule.effect == "PERMIT" else "PERMIT"
    return {"rule": rule.id, "shard": changed[0],
            "decision": [before, after], "ttv_ms": ttv_ms,
            "launches": launches,
            "checked": {k: [v["calls"], v["max_abs_err"]]
                        for k, v in check.items()},
            "rows": len(batch), "new_builds": 0}


def rank_device(rank: int) -> torch.device:
    """A rank's card, ``cuda:{rank % device_count}``, made current."""
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def phase15_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank of phase 15 (``launch_local``, gloo, every rank on the one
    card): the single-device evaluator's responses, then each mesh
    configuration's ``HybridEvaluator`` with the counts set to 0 just
    before its first batch and read just after, every kernel call of that
    batch held against its plain version; every response equal to the
    single device's, a sample (rank 0) equal to the oracle; warm
    decisions/s and the stage times; the pod patch at (1, 4)."""
    from access_control_srv_tpu_torch.parallel import make_mesh2

    device = rank_device(rank)
    engine = shard_scale_engine()
    small = engine_for("scoped_511")
    traffic = {
        "shard-scale": (engine, shard_scale_traffic()),
        "shard-scale ACL": (engine, shard_scale_traffic(n_acl=16)),
        "scoped_511": (small, grid_requests(random.Random(5), SHARD_ROWS,
                                            stress=True)),
    }
    want = {}
    for key, (eng, reqs) in traffic.items():
        single = HybridEvaluator(eng, device=device)
        want[key] = [response_key(x) for x in
                     single.is_allowed_batch(clone(reqs))]
        del single
    # the explain layouts' yardstick: the single-device explain evaluator
    want_explain = {}
    for key in ("scoped_511", "shard-scale"):
        eng, reqs = traffic[key]
        single = HybridEvaluator(eng, device=device, explain=True)
        want_explain[key] = [explain_key(x) for x in
                             single.is_allowed_batch(clone(reqs))]
        del single
    configs = [
        ("K6 mesh (4,1)", "scoped_511", (4, 1), {}),
        ("K3 mesh (4,1)", "shard-scale", (4, 1), {}),
        ("K4 mesh (4,1)", "shard-scale ACL", (4, 1), {}),
        ("K7 model_axis (2,2)", "shard-scale", (2, 2),
         {"model_axis": "model"}),
        ("K7 model_axis (1,4)", "shard-scale", (1, 4),
         {"model_axis": "model"}),
        ("K8 pod_shards (2,2)", "shard-scale", (2, 2),
         {"model_axis": "model", "pod_shards": 2}),
        ("K8 pod_shards (1,4)", "shard-scale", (1, 4),
         {"model_axis": "model", "pod_shards": 4}),
        ("explain K6 mesh (4,1)", "scoped_511", (4, 1), {"explain": True}),
        ("explain K7 model_axis (1,4)", "shard-scale", (1, 4),
         {"model_axis": "model", "explain": True}),
        ("explain K8 pod_shards (1,4)", "shard-scale", (1, 4),
         {"model_axis": "model", "pod_shards": 4, "explain": True}),
    ]
    meshes: dict = {}
    res: dict = {"layouts": {}}
    gate_wait_s = 0.0
    for label, key, layout, kw in configs:
        if layout not in meshes:
            meshes[layout] = make_mesh2(*layout, device=device)
        eng, reqs = traffic[key]
        ev = HybridEvaluator(eng, mesh=meshes[layout], **kw)
        check: dict = {}
        _reset_counts()
        with KernelCheck(check, names=tuple(PLAIN)) as chk:
            got = ev.is_allowed_batch(clone(reqs))
        launches = {k: v for k, v in kmod.LAUNCHES.items() if v}
        colls = dict(mmod.COLLECTIVES)
        # the plain versions' cached blocks go back to the card before the
        # warm batches: four ranks share its memory
        reserved = torch.cuda.memory_reserved(device)
        torch.cuda.empty_cache()
        bad = [i for i, g in enumerate(got) if response_key(g) != want[key][i]]
        if kw.get("explain"):
            bad += [i for i, g in enumerate(got)
                    if explain_key(g) != want_explain[key][i]]
        if bad:
            raise AssertionError(f"{label} rank {rank}: rows {bad[:8]} differ "
                                 f"from the single device")
        sampled = sample_oracle(eng, reqs, got) if rank == 0 else 0
        # no timing before this process's other work of the run is done
        gate_wait_s += wait_for(os.path.join(out_dir, GATE))
        ev.is_allowed_batch(clone(reqs))
        t0 = time.perf_counter()
        for _ in range(3):
            ev.is_allowed_batch(reqs)
        dt = (time.perf_counter() - t0) / 3
        kernel = ev._kernel
        if "model_axis" in kw:
            stage_kernel = kernel
        elif key == "scoped_511":
            stage_kernel = kernel._dense
        else:
            stage_kernel = None
        stages = {} if stage_kernel is None else layout_stage_times(
            stage_kernel, chk.calls, check, chk.kw)
        res["layouts"][label] = {
            "rows": len(reqs), "kernel": type(kernel).__name__,
            "launches": launches, "collectives": colls,
            "checked": {k: [v["calls"], v["max_abs_err"]]
                        for k, v in check.items()},
            "decisions_per_s": len(reqs) / dt, "batch_ms": dt * 1e3,
            "reserved_after_check": reserved, "oracle_rows": sampled,
            **stages}
        del chk
        if label == "K8 pod_shards (1,4)":
            res["patch"] = pod_patch_check(eng, ev, device, reqs, rank)
        del ev, kernel, stage_kernel
        torch.cuda.empty_cache()
    res["gate_wait_s"] = gate_wait_s
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


# phase 15's gate: the file the main process writes when ``meanwhile``
# is done; no rank times anything before it exists
GATE = "meanwhile.done"


def wait_for(path: str, timeout_s: float = 600.0) -> float:
    """Wait until ``path`` exists; returns the seconds waited."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def phase15(card: str, meanwhile=None) -> dict:
    """Phase 15: four ranks sharing the card over gloo (NCCL does not put
    two ranks of one communicator on one GPU); returns rank 0's results
    with the launches summed, and the checked calls and errors maxed, over
    the ranks.  ``meanwhile`` (a callable) runs in this process while the
    ranks build and check; each rank waits for it (``GATE``) before its
    first timed batch, so no timing shares the card or the host with
    it."""
    from access_control_srv_tpu_torch.parallel import launch_local

    out_dir = tempfile.mkdtemp(prefix="acs-phase15-")
    t0 = time.perf_counter()
    failed: list = []

    def ranks() -> None:
        try:
            launch_local(4, "chip_smoke:phase15_rank", (out_dir,),
                         backend="gloo", timeout_s=700)
        except BaseException as err:  # noqa: BLE001 — raised below
            failed.append(err)

    world = threading.Thread(target=ranks, name="phase15")
    world.start()
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        with open(os.path.join(out_dir, GATE), "w"):
            pass
        world.join()
    if failed:
        raise failed[0]
    ranks = []
    for rank in range(4):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    shutil.rmtree(out_dir)
    res = ranks[0]
    log(f"  the ranks waited {max(rk['gate_wait_s'] for rk in ranks):.1f} "
        f"s (the longest) for this process's other work before their "
        f"first timed batch")
    for label, row in res["layouts"].items():
        total: dict = {}
        err: dict = {}
        for rk in ranks:
            rl = rk["layouts"][label]
            for k, v in rl["launches"].items():
                total[k] = total.get(k, 0) + v
            for k, (calls, e) in rl["checked"].items():
                c0, e0 = err.get(k, (0, 0))
                err[k] = (c0 + calls, max(e0, e))
        row["launches_all_ranks"] = total
        row["max_abs_err_all_ranks"] = {k: e for k, (_, e) in err.items()}
        # each kernel's row is its slowest rank's launch (the layout's
        # critical path), with every rank's ms beside it
        for name in row.get("kernels", {}):
            per = [rk["layouts"][label]["kernels"][name] for rk in ranks]
            slow = max(range(len(per)), key=lambda i: per[i]["ms"])
            row["kernels"][name] = {**per[slow], "rank": slow,
                                    "ms_per_rank": [t["ms"] for t in per]}
        stage = {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in row.items() if k.endswith("_ms")
                 or k == "merge_bytes"}
        log(f"  {label} [{row['kernel']}]: {row['rows']} rows, every rank's "
            f"responses equal to the single device ({row['oracle_rows']} "
            f"sampled equal to the oracle); kernel calls held against "
            f"their plain versions (all ranks: calls, max abs err) "
            f"{json.dumps(err)}; {row['decisions_per_s']:.0f} decisions/s "
            f"per rank; launches (all ranks) {total}; collectives per rank "
            f"{row['collectives']}; {row['reserved_after_check']} bytes "
            f"reserved after the checked batch (rank 0); stages (rank 0) "
            f"{json.dumps(stage)} on "
            f"{card} (gloo, 4 ranks on one card)")
        for name, t in row.get("kernels", {}).items():
            log(f"    {name} at this layout's main-path shapes, each rank "
                f"timed alone, slowest rank on {card}: {json.dumps(t)}")
    p = res["patch"]
    p["launches_all_ranks"] = {}
    for rk in ranks:
        for k, v in rk["patch"]["launches"].items():
            p["launches_all_ranks"][k] = p["launches_all_ranks"].get(k, 0) + v
        for k, (_, e) in rk["patch"]["checked"].items():
            p["max_abs_err"] = max(p.get("max_abs_err", 0), e)
    log(f"  pod patch at (1,4) through HybridEvaluator.refresh(events=...): "
        f"rule {p['rule']} flipped, one patch counted, shard {p['shard']} "
        f"re-sliced alone (fingerprint and applied-patch count), the probe "
        f"{p['decision'][0]} -> {p['decision'][1]} as the oracle, "
        f"{p['ttv_ms']:.1f} ms for the refresh on rank 0; one batch of "
        f"{p['rows']} rows on the patched tables: launches (all ranks) "
        f"{p['launches_all_ranks']}, every set_chunk / shard_tail call "
        f"equal to its plain version (max abs err "
        f"{p.get('max_abs_err', 0)}), every response equal to the single "
        f"device's; no library built; on {card}")
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")
    return res


def phase16_rank(rank: int, world: int, out_dir: str) -> None:
    """Phase 16's one rank (NCCL, world size 1): the rule- and
    pod-sharded evaluators at (1, 1) against the single device, and the
    merge rows' MIN all_reduce through NCCL on the card (CUDA events)."""
    import torch.distributed as dist

    from access_control_srv_tpu_torch.parallel import make_mesh2
    from access_control_srv_tpu_torch.parallel.mesh import row_slice

    device = rank_device(rank)
    engine = shard_scale_engine()
    reqs = shard_scale_traffic()
    want = [response_key(x) for x in HybridEvaluator(
        engine, device=device).is_allowed_batch(clone(reqs))]
    mesh = make_mesh2(1, 1, device=device)
    res = {"backend": mesh.backend}
    for label, kw in (("K7", {"model_axis": "model"}),
                      ("K8", {"model_axis": "model", "pod_shards": 1})):
        ev = HybridEvaluator(engine, mesh=mesh, **kw)
        reset_launches()
        got = ev.is_allowed_batch(clone(reqs))
        if [response_key(g) for g in got] != want:
            raise AssertionError(f"phase 16 {label}: responses differ")
        res[label] = {"launches": {k: v for k, v in kmod.LAUNCHES.items()
                                   if v}}
    k = ev._kernel
    batch = encode_requests(clone(reqs), ev._compiled,
                            caps=dict(_CAPS_FLOOR))
    _, r = row_slice(batch, device, kmod.ROW_ARRAYS, 1, 0)
    merge = kmod.set_chunk(k._c, r, k._own.s_lo, 1, 0,
                           *shard_flags(ev._compiled, batch),
                           t_live=k._own.t_live)
    res["nccl_all_reduce_ms"] = _host_ms(
        lambda: dist.all_reduce(merge, op=dist.ReduceOp.MIN))
    res["merge_bytes"] = int(merge.nbytes)
    with open(os.path.join(out_dir, "rank0.json"), "w") as fh:
        json.dump(res, fh)


def phase16(card: str) -> dict:
    from access_control_srv_tpu_torch.parallel import launch_local

    out_dir = tempfile.mkdtemp(prefix="acs-phase16-")
    launch_local(1, "chip_smoke:phase16_rank", (out_dir,), backend="nccl",
                 timeout_s=300)
    with open(os.path.join(out_dir, "rank0.json")) as fh:
        res = json.load(fh)
    shutil.rmtree(out_dir)
    log(f"  NCCL world size 1: K7 launches {res['K7']['launches']}, K8 "
        f"launches {res['K8']['launches']}, responses equal to the single "
        f"device; NCCL MIN all_reduce of {res['merge_bytes']} bytes "
        f"{res['nccl_all_reduce_ms']:.4f} ms on {card}")
    return res


def sharded_row(p15: dict, name: str, program: str,
                explain: bool = False) -> dict:
    """A kernel's numbers on phase 15's main path for ``program`` (K6,
    K7 or K8; with ``explain`` its explain layout and the kernel's
    explain variant): ms, plain ms and bound from the slowest rank's
    launches of one batch in the program's (4, 1) or (1, 4) layout, the
    launches and the largest error over all its layouts and ranks."""
    prefix = ("explain " if explain else "") + program + " "
    key = name + ("+explain" if explain else "")
    layouts = {k: v for k, v in p15["layouts"].items()
               if k.startswith(prefix)}
    launches = sum(v["launches_all_ranks"].get(name, 0)
                   for v in layouts.values())
    if not launches:
        raise AssertionError(f"phase 15's {prefix.strip()} layouts "
                             f"launched no {name}")
    err = max(v["max_abs_err_all_ranks"].get(name, 0)
              for v in layouts.values())
    t = next(v for k, v in layouts.items()
             if k.endswith(("(1,4)", "(4,1)")))["kernels"][key]
    return {"launches": launches, "max_abs_err": err,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "yardstick_ms") if k in t}}


# ----------------------------------------------- explain mode (phases 17-18)

# the JAX package's explain-overhead configuration (bench_all.py
# bench_explain_overhead): _stress_doc(20_000), one 4,096-row batch of
# bench_stress traffic at numpy seed 7, evaluated 8 times
EXPLAIN_RULES = 20_000
EXPLAIN_ROWS = 4096
EXPLAIN_BATCHES = 8
# the ACL batch of phase 18 (decide_grouped's explain variant): phase 7
# (c)'s shape
EXPLAIN_ACL_ROWS = 16384
# the explain recovery each kernel's explain variant replaces (file:line)
REPLACES_EXPLAIN = {
    "decide_dense": "access_control_srv_tpu/ops/kernel.py:1165",
    "sig_decide": "access_control_srv_tpu/ops/kernel.py:920",
    "decide_grouped": "access_control_srv_tpu/ops/prefilter.py:334",
    "set_chunk": "access_control_srv_tpu/parallel/pod_shard.py:273",
    "shard_tail": "access_control_srv_tpu/parallel/rule_shard.py:263",
}
EXPLAIN_TAIL_ALSO_REPLACES = "access_control_srv_tpu/parallel/pod_shard.py:273"


def explain_sources(engine, strides, requests, out, rows) -> int:
    """Kernel rows (eligible, status 200) among ``rows``: the decoded
    provenance source equal to the oracle's ``_rule_id``."""
    decoder = ExplainDecoder(engine.policy_sets, strides)
    host = [np.asarray(o) for o in out]
    idx = [i for i in rows if int(host[2][i]) == 200]
    for i, want in zip(idx, oracle_walks(engine, requests, idx)):
        got = decoder.source(int(host[3][i]))
        if got != getattr(want, "_rule_id", None):
            raise AssertionError(f"row {i}: explain source {got!r} != "
                                 f"oracle {getattr(want, '_rule_id', None)!r}")
    return len(idx)


def same_eligible(a, b, eligible, what: str) -> None:
    for x, y in zip(a, b):
        if not np.array_equal(np.asarray(x)[eligible],
                              np.asarray(y)[eligible]):
            raise AssertionError(f"{what}: outputs differ")


def phase_explain_vs_plain(device, stats: dict) -> None:
    """Phase 17: every explain call of ``decide_dense``, ``sig_decide``
    and ``decide_grouped`` held exactly against its plain version (all
    four outputs) on every supported fixture tree, the 511-rule scoped
    tree and the seed data (``DecisionKernel`` and a forced
    ``PrefilteredKernel``, ACL / property and signature batches), the
    720-rule stress tree with conditions and aborts, and the relation
    variants of phase 12; the dense and signature paths' codes equal on
    eligible rows and sampled codes decoded to the oracle's ``_rule_id``;
    then ``set_chunk`` / ``shard_tail`` explain on the shard-scale tree's
    4-way rule and set partitions."""
    n_src = 0
    with KernelCheck(stats, dense=True):
        for name in tree_names():
            engine = engine_for(name)
            compiled = compile_policies(engine.policy_sets, engine.urns)
            if not compiled.supported or compiled.n_rules == 0:
                continue
            rng = random.Random(zlib.crc32(("explain " + name).encode()))
            stress = name == "scoped_511"
            dense = kmod.DecisionKernel(compiled, device=device,
                                        explain=True)
            forced = pfmod.PrefilteredKernel(compiled, device=device,
                                             explain=True)
            forced.active, forced._dense = True, None
            for reqs in (grid_requests(rng, 192, stress)
                         + odd_requests(rng, stress),
                         grid_requests(rng, 128, stress, acl=False,
                                       props=False)):
                batch = encode_requests(clone(reqs), compiled)
                out = dense.evaluate(batch)
                same_eligible(out, forced.evaluate(batch), batch.eligible,
                              f"{name}: dense vs signature path")
                n_src += explain_sources(
                    engine, dense.explain_strides, reqs, out,
                    [i for i in range(0, len(reqs), 8)
                     if batch.eligible[i]])
            log(f"  {name}: dense and forced signature explain calls equal "
                f"to their plain versions and to each other")
        for label, kw in (("stress-720 conditions", {"conditions": True}),
                          ("stress-720 HR", {"scoped": True})):
            engine = engine_from_doc(small_stress_doc(**kw))
            compiled = compile_policies(engine.policy_sets, engine.urns)
            kern = pfmod.PrefilteredKernel(compiled, device=device,
                                           explain=True)
            rng = random.Random(zlib.crc32(("explain " + label).encode()))
            for reqs in (grid_requests(rng, 384, stress=True, acl=False),
                         grid_requests(rng, 128, stress=True)):
                for r in reqs[::5]:  # no subject id: the conditions abort
                    r.context["subject"].pop("id", None)
                batch = encode_requests(clone(reqs), compiled)
                out = kern.evaluate(batch)
                kinds = sorted(set((out[3][batch.eligible] & 3).tolist()))
                n_src += explain_sources(engine, kern.explain_strides, reqs,
                                         out, range(0, len(reqs), 16))
                log(f"  {label}: {len(reqs)} rows, explain calls equal to "
                    f"their plain versions; code kinds {kinds}")
        for label, engine, store, reqs, kw in rel_fixture_cases():
            compiled = compile_policies(engine.policy_sets, engine.urns)
            tables = store.tables_for(compiled) if store else None
            batch = encode_requests(clone(reqs), compiled,
                                    relation_tables=tables, **kw)
            dense = kmod.DecisionKernel(compiled, device=device,
                                        explain=True)
            forced = pfmod.PrefilteredKernel(compiled, device=device,
                                             explain=True)
            forced.active, forced._dense = True, None
            out = dense.evaluate(batch)
            same_eligible(out, forced.evaluate(batch), batch.eligible,
                          f"{label}: dense vs signature path")
        for scoped in (False, True):
            engine = engine_from_doc(rel_stress_doc(scoped))
            compiled = compile_policies(engine.policy_sets, engine.urns)
            tables = rel_stress_store().tables_for(compiled)
            kern = pfmod.PrefilteredKernel(compiled, device=device,
                                           explain=True)
            for acl in (False, True):
                reqs = rel_stress_traffic(256, 31 + acl, scoped, acl)
                kern.evaluate(encode_requests(clone(reqs), compiled,
                                              relation_tables=tables))
        log("  relation variants (phase 12's fixture cases, 720 relation "
            "tree): explain calls equal to their plain versions")
    for name in ("decide_dense", "sig_decide", "decide_grouped"):
        st = stats.get(name, {})
        if not st.get("explain_calls"):
            raise AssertionError(f"phase 17 never ran {name}'s explain "
                                 f"variant")
    engine = shard_scale_engine()
    compiled = compile_policies(engine.policy_sets, engine.urns)
    batch = encode_requests(shard_scale_traffic(), compiled)
    want = single_device_out(compiled, batch, device, explain=True)
    check_sharded("shard-scale explain", compiled, batch, device, 4, want,
                  stats, explain=True)
    log(f"  {n_src} sampled codes decoded to the oracle's _rule_id; max abs "
        f"err: " + json.dumps({k: stats[k].get("explain_err",
                                               stats[k]["max_abs_err"])
                               for k in ("decide_dense", "sig_decide",
                                         "decide_grouped",
                                         "set_chunk+explain",
                                         "shard_tail+explain")}))


def bound_explain_sig(args) -> tuple[float, str, int, int]:
    """``sig_decide``'s bound in explain mode: the explain-off bound's
    bytes plus the stacked ``rule_orig_flat`` read and the fourth output
    written; per real row one more policy's rule walk."""
    _, _, nbytes, ops = bound_sig_decide(args)
    inv, cs, gp, n_rows = args[0], args[1], args[6], args[7]
    live = live_extents({**inv, **cs})
    nbytes += live_nbytes(kmod.ORIG_TABLE, cs[kmod.ORIG_TABLE], live) \
        + 4 * int(gp.shape[0])
    return _finish_bound(nbytes, ops + n_rows * live["KR"] * 12)


def pipelined_rate(kernel, batch, iters: int = EXPLAIN_BATCHES) -> float:
    """Decisions/s of ``iters`` launches of one batch through
    ``evaluate_async`` with up to three in flight (the JAX bench's depth),
    after a warm-up batch; host clock."""
    kernel.evaluate(batch)
    t0 = time.perf_counter()
    pending = []
    for _ in range(iters):
        if len(pending) >= 3:
            pending.pop(0)()
        pending.append(kernel.evaluate_async(batch))
    for p in pending:
        p()
    return batch.B * iters / (time.perf_counter() - t0)


def explain_tree(device) -> tuple:
    """Phase 18's tree and explain evaluator: (engine, evaluator, seconds
    to load and compile)."""
    t0 = time.perf_counter()
    engine = engine_from_doc(stress_doc(EXPLAIN_RULES))
    evaluator = HybridEvaluator(engine, device=device, explain=True)
    return engine, evaluator, time.perf_counter() - t0


def phase_explain_main(device, stats: dict, card: str, pre: tuple) -> dict:
    """Phase 18, the explain main path on the JAX package's
    ``explain-overhead`` configuration: ``HybridEvaluator(engine,
    explain=True).is_allowed_batch`` on 8 batches of 4,096
    ``stress_traffic(seed=7)`` rows against the 20,000-rule tree; counts
    zeroed before the first batch and read after it, every kernel call of
    that batch held against its plain version, every response against
    the oracle (decision, status, ``_rule_id``); warm decisions/s; then
    explain-off against explain-on on the same tables and batch; then one
    16,384-row batch with 16 ACL rows (``decide_grouped``'s explain
    variant).  ``pre``: ``explain_tree``'s result, built earlier."""
    out: dict = {}
    engine, evaluator, secs = pre
    compiled = evaluator._compiled
    kern = evaluator._kernel
    if not (kern.active and kern.explain):
        raise AssertionError("the 20k tree did not take the explain "
                             "signature path")
    log(f"  explain-overhead tree: {compiled.n_rules} rules, S={compiled.S}"
        f" KP={compiled.KP} KR={compiled.KR} T={compiled.T} "
        f"({secs:.1f} s)")
    reqs = stress_traffic(EXPLAIN_ROWS, seed=7)
    check: dict = {}
    reset_launches()
    with KernelCheck(check) as chk:
        first = evaluator.is_allowed_batch(clone(reqs))
    launches = dict(kmod.LAUNCHES)
    if not (launches["sig_planes"] and launches["sig_decide"]
            and check["sig_decide"].get("explain_calls")):
        raise AssertionError(f"explain main path launches {launches}")
    t0 = time.perf_counter()
    wants = oracle_walks(engine, reqs, range(len(reqs)),
                         cand=evaluator._cand[1])
    n_src = 0
    for i, (resp, want) in enumerate(zip(first, wants)):
        got_key = (resp.decision, resp.operation_status.code,
                   getattr(resp, "_rule_id", None))
        want_key = (want.decision, want.operation_status.code,
                    getattr(want, "_rule_id", None))
        if got_key != want_key:
            raise AssertionError(f"explain row {i}: {got_key} != oracle "
                                 f"{want_key}")
        n_src += got_key[2] is not None
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(EXPLAIN_BATCHES - 1):
        evaluator.is_allowed_batch(reqs)
    dt = (time.perf_counter() - t0) / (EXPLAIN_BATCHES - 1)
    out["first_batch"] = {
        "launches": launches, "rows": len(reqs), "with_rule_id": n_src,
        "max_abs_err": {k: v["max_abs_err"] for k, v in check.items()},
        "oracle_s": oracle_s}
    out["evaluator"] = {"decisions_per_s": len(reqs) / dt,
                        "batch_ms": dt * 1e3}
    log(f"  first batch: launches {launches}; every kernel call equal to "
        f"its plain version; all {len(reqs)} responses equal to the oracle "
        f"(decision, status, _rule_id; {n_src} with a _rule_id; "
        f"{oracle_s:.1f} s of oracle); warm evaluator "
        f"{len(reqs) / dt:.0f} decisions/s ({dt * 1e3:.3f} ms per batch) "
        f"on {card}")

    # explain off against on: the same compiled tables and batch
    batch = encode_requests(reqs, compiled)
    k_off = pfmod.PrefilteredKernel(compiled, device=device)
    k_on = pfmod.PrefilteredKernel(compiled, device=device, explain=True)
    rates = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        rates[which].append(pipelined_rate(k_off if which == "off"
                                           else k_on, batch))
    off = sum(rates["off"]) / 2
    on = sum(rates["on"]) / 2
    args = chk.args["sig_decide+explain"]
    sig = {
        **redesigned_times("sig_decide", args, (True, False)),
        "plain_ms": time_ms(lambda: prefilter_ref.sig_decide_ref(
            *args, explain=True), 1),
        "flags": [bool(f) for f in args[-2:]],
    }
    sig["bound_ms"], sig["bound_by"], sig["bytes"], sig["ops"] = \
        bound_explain_sig(args)
    sig["launches"] = launches["sig_decide"]
    out["overhead"] = {"explain_off_dps": rates["off"],
                       "explain_on_dps": rates["on"],
                       "overhead_pct": (off / on - 1.0) * 100.0}
    out["sig_decide"] = sig
    log(f"  PrefilteredKernel on {card}: explain off {off:.0f} / on "
        f"{on:.0f} decisions/s (off, on, on, off: "
        f"{json.dumps(rates)}); overhead_pct "
        f"{out['overhead']['overhead_pct']:.2f} (the JAX package's bar: "
        f"< 20, reported, not gated)")
    log(f"  sig_decide explain on {card}: " + json.dumps(sig))
    out["steady"] = steady_state(evaluator, reqs)
    log(f"  explain evaluator stages (ms) on {card}: "
        + json.dumps(out["steady"]["stages_ms"]))

    # one ACL batch on the same tree: decide_grouped's explain variant
    reqs_c = stress_traffic(EXPLAIN_ACL_ROWS, seed=7, n_acl=16)
    acl_rows = [i for i, r in enumerate(reqs_c) if r.context["resources"]]
    check_c: dict = {}
    reset_launches()
    with KernelCheck(check_c) as chk_c:
        got_c = evaluator.is_allowed_batch(clone(reqs_c))
    launches_c = dict(kmod.LAUNCHES)
    if not (launches_c["decide_grouped"]
            and check_c["decide_grouped"].get("explain_calls")):
        raise AssertionError(f"explain ACL batch launches {launches_c}")
    rows = sorted(set(random.Random(3).sample(range(len(reqs_c)), 32))
                  | set(acl_rows))
    for i, want in zip(rows, oracle_walks(engine, reqs_c, rows)):
        got_key = (response_key(got_c[i]), getattr(got_c[i], "_rule_id",
                                                   None))
        want_key = (response_key(want), getattr(want, "_rule_id", None))
        if got_key != want_key:
            raise AssertionError(f"explain ACL row {i}: {got_key} != "
                                 f"{want_key}")
    g_args = chk_c.args["decide_grouped+explain"]
    inv, cs, _, r, _, _, with_rel = g_args
    _, _, nbytes, ops = bound_ms({**inv, **cs}, r, with_rel,
                                 every_pair=True)
    # plus the stacked rule_orig_flat read and the fourth output written
    orig = live_nbytes(kmod.ORIG_TABLE, cs[kmod.ORIG_TABLE],
                       live_extents({**inv, **cs}))
    bms, by, _, _ = _finish_bound(
        nbytes + orig + 4 * int(r["r_n_ra"].shape[0]), ops)
    grouped = {
        "launches": launches_c["decide_grouped"],
        **redesigned_times("decide_grouped", g_args, (True, False)),
        "plain_ms": time_ms(lambda: grouped_plain(*g_args, explain=True),
                            1),
        "bound_ms": bms, "bound_by": by,
        "flags": [bool(f) for f in g_args[-3:]],
    }
    out["decide_grouped"] = grouped
    out["acl_batch"] = {"launches": launches_c, "oracle_rows": len(rows),
                        "max_abs_err": {k: v["max_abs_err"]
                                        for k, v in check_c.items()}}
    log(f"  ACL batch ({len(reqs_c)} rows, 16 ACL rows): launches "
        f"{launches_c}; "
        f"every kernel call equal to its plain version; {len(rows)} "
        f"responses (the ACL rows and 32 sampled) equal to the oracle with "
        f"_rule_id; decide_grouped explain on {card}: "
        + json.dumps(grouped))
    for k, v in list(check.items()) + list(check_c.items()):
        st = stats.setdefault(k, {"calls": 0, "max_abs_err": 0,
                                  "variants": set()})
        st["max_abs_err"] = max(st["max_abs_err"], v["max_abs_err"])
        st["explain_err"] = max(st.get("explain_err", 0),
                                v.get("explain_err", 0))
    return out


def redesign_report(sig: dict, expl: dict, ptx: dict, card: str) -> None:
    """K3 and K4 at the main paths' shapes beside their bounds (and the
    ratio), the parent tree's kernels on the same arguments when
    ``--parent-csrc`` names one (else the times PERF.md records for the
    design before), ptxas's registers and spills, and the resident
    blocks per SM.  Each time twice: through the wrapper (``ms``, as
    every kernel of the kernel table) and of arguments packed once
    (``kernel_ms``)."""
    def ptx_of(name: str, flags: list, explain: bool) -> str:
        key = (f"{name}_kernel<" + ",".join(str(int(f)) for f in flags)
               + f",{int(explain)}>")
        v = ptx.get(key)
        return (f"{key} {v[0]} registers, spills {v[1]} / {v[2]} B" if v
                else f"{key} (no ptxas report)")

    def times(t: dict, sfx: str = "") -> str:
        out = (f"wrapper {t['ms' + sfx]:.4f} ms, packed once "
               f"{t['kernel_ms' + sfx]:.4f} ms")
        if "parent_ms" + sfx in t:
            pw, pk = t["parent_ms" + sfx], t["parent_kernel_ms" + sfx]
            out += (f"; parent wrapper {pw:.4f} ms "
                    f"({pw / t['ms' + sfx]:.2f}x), parent packed once "
                    f"{pk:.4f} ms ({pk / t['kernel_ms' + sfx]:.2f}x)")
        return out

    for name, cell in (("sig_decide", "a"), ("sig_decide", "b"),
                       ("decide_grouped", "c")):
        t = sig[cell][name]
        log(f"  {name} ({cell}) on {card}: {times(t)}; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), packed once "
            f"{t['kernel_ms'] / t['bound_ms']:.1f}x the bound; PERF.md "
            f"before: {OLD_MS[(name, cell)]} ms; "
            f"{ptx_of(name, t['flags'], False)}; "
            f"{t['blocks_per_sm']} blocks per SM")
    for name in ("sig_decide", "decide_grouped"):
        t = expl[name]
        log(f"  {name} explain (phase 18) on {card}: on {times(t)}; off "
            f"{times(t, '_explain_off')}; on against off packed once "
            f"{(t['kernel_ms'] / t['kernel_ms_explain_off'] - 1) * 100:+.1f}"
            f"%, through the wrapper "
            f"{(t['ms'] / t['ms_explain_off'] - 1) * 100:+.1f}%; bound "
            f"{t['bound_ms']:.4f} ms; PERF.md before: "
            f"{OLD_MS[(name, 'explain')]} ms; "
            f"{ptx_of(name, t['flags'], True)}, {t['blocks_per_sm']} blocks "
            f"per SM; {ptx_of(name, t['flags'], False)}, "
            f"{t['blocks_per_sm_explain_off']} blocks per SM")


# -------------------------------------- the rows program (K1, K6 and K8)


def evaluator_batches(compiled, engine, requests) -> list:
    """The batches ``HybridEvaluator.is_allowed_batch`` encodes for
    ``requests``: the floor-fitting rows at the floor caps, then the rest
    at batch-max caps (one batch when either part is empty)."""
    reqs = clone(requests)
    wide = [not fits_floor(request_needs(r, compiled.urns)) for r in reqs]
    parts = [(reqs, None)]
    if len(reqs) >= 8 and 0 < sum(wide) < len(reqs):
        parts = [([r for r, w in zip(reqs, wide) if not w],
                  dict(_CAPS_FLOOR)),
                 ([r for r, w in zip(reqs, wide) if w], None)]
    return [encode_requests(rows, compiled, engine.resource_adapter,
                            caps=caps) for rows, caps in parts]


def k6_calls(device) -> list:
    """Rank 0's ``decide_dense`` calls at mesh (4, 1) on phase 15's
    ``scoped_511`` traffic, rebuilt in this process: its 512-row slice
    of the floor batch and its 8-row slice of the wide rows."""
    engine = engine_for("scoped_511")
    compiled = compile_policies(engine.policy_sets, engine.urns)
    c = tables_from_numpy(compiled.arrays, device, keys=kmod.TABLE_ARRAYS)
    reqs = grid_requests(random.Random(5), SHARD_ROWS, stress=True)
    out = []
    for batch in evaluator_batches(compiled, engine, reqs):
        _, r = mmod.row_slice(batch, device, kmod.ROW_ARRAYS, 4, 0)
        out.append((c, r) + shard_flags(compiled, batch))
    return out


def local_mesh(device, n_data: int, n_model: int, d: int) -> "mmod.Mesh":
    """A mesh without collectives at data coordinate 0 and model
    coordinate ``d`` of layout (n_data, n_model): a sharded kernel's rank
    rebuilt in this process."""
    return mmod.Mesh(axis_names=("data", "model"),
                     shape={"data": n_data, "model": n_model},
                     coords={"data": 0, "model": d},
                     groups={"data": None, "model": None}, backend=None,
                     device=device)


_SHARD_TREE: list = []


def shard_scale_tree() -> tuple:
    """(engine, compile) of the shard-scale tree, built once for the
    reports."""
    if not _SHARD_TREE:
        engine = shard_scale_engine()
        _SHARD_TREE.extend(
            (engine, compile_policies(engine.policy_sets, engine.urns)))
    return tuple(_SHARD_TREE)


def pod_call(device, n_data: int, n_model: int) -> tuple:
    """The ``set_chunk`` call of the shard-scale tree's stress shard (the
    one with the most live target rows) at pod layout (n_data, n_model),
    data coordinate 0, rebuilt in this process: ``PodShardedKernel`` on
    a mesh without collectives at that shard's coordinates -> (args,
    keywords, the shard's t_live and the kernel's t_cap)."""
    engine, compiled = shard_scale_tree()
    shards, _ = pod_shard.partition_sets(compiled, n_model)
    d = max(range(n_model), key=lambda i: shards[i].t_live)
    kern = pod_shard.PodShardedKernel(compiled,
                                      local_mesh(device, n_data, n_model, d))
    (batch,) = evaluator_batches(compiled, engine, shard_scale_traffic())
    _, r = mmod.row_slice(batch, device, kmod.ROW_ARRAYS, n_data, 0)
    args = (kern._c, r, kern._own.s_lo, n_model, d) + shard_flags(compiled,
                                                                  batch)
    return args, {"t_live": kern._own.t_live}, kern.t_cap


def rows_cases(device, stats: dict, rebac: dict) -> dict:
    """The main-path calls of the rows program, by cell: (kernel, args,
    keywords, explain flags to time)."""
    cases = {"scoped_511": ("decide_dense", stats["main"]["args"], {},
                            (True, False))}
    for args, label in zip(k6_calls(device), ("K6 (4,1) 512 rows",
                                              "K6 (4,1) 8 rows")):
        cases[label] = ("decide_dense", args, {}, (False,))
    cases["rebac-serve"] = ("decide_dense", rebac["k1_args"], {}, (False,))
    for layout in ((1, 4), (2, 2)):
        args, kw, t_cap = pod_call(device, *layout)
        cases[f"set_chunk {layout}".replace(" ", "")] = (
            "set_chunk", args, kw, (True, False))
        log(f"  set_chunk {layout}: stress shard {args[4]}, "
            f"{int(args[1]['r_n_ra'].shape[0])} rows, t_live "
            f"{kw['t_live']} of t_cap {t_cap}")
    return cases


def target_rows(c: dict) -> int:
    """The target rows a rule shard's tables reference (its compacted
    subtable before the padding to the shards' common T)."""
    refs = [c[k + "_target"][c[k + "_has_target"].bool()]
            for k in ("rule", "pol", "set")]
    refs.append(torch.zeros(1, dtype=refs[0].dtype, device=refs[0].device))
    return int(torch.unique(torch.cat([x.flatten() for x in refs])).numel())


def k7_cases(device) -> dict:
    """The main-path calls of K7's ``rule_chunk`` and of ``shard_tail``
    in both modes, rebuilt in this process on the shard-scale tree's
    batch at the (1,4) and (2,2) layouts, data coordinate 0: ``rule_chunk``
    of ``RuleShardedKernel`` at the rule shard with the most target rows;
    the K7 tail on the MIN over every rule shard's merge rows (each
    shard's kernel at its own coordinate, merged on the device, no
    collective), with the kernel's packed tail tables; the K8 tail on the
    MIN over every set shard's ``set_chunk`` rows (``PodShardedKernel``
    per coordinate; explain on from the explain rows, a cell of its own).
    By cell: (kernel, args, keywords, explain flags to time)."""
    engine, compiled = shard_scale_tree()
    (batch,) = evaluator_batches(compiled, engine, shard_scale_traffic())
    flags = shard_flags(compiled, batch)
    cases = {}
    for n_data, n_model in ((1, 4), (2, 2)):
        layout = f"({n_data},{n_model})"
        _, r = mmod.row_slice(batch, device, kmod.ROW_ARRAYS, n_data, 0)
        rules = [rule_shard.RuleShardedKernel(
            compiled, local_mesh(device, n_data, n_model, d))
            for d in range(n_model)]
        calls = [(k._c, r, k._kr_offset, k._kr_total, n_model, d) + flags
                 for d, k in enumerate(rules)]
        t_rows = [target_rows(k._c) for k in rules]
        d = max(range(n_model), key=t_rows.__getitem__)
        cases["rule_chunk" + layout] = ("rule_chunk", calls[d], {}, (False,))
        merged = torch.stack([kmod.rule_chunk(*a) for a in calls]).amin(0)
        cases["shard_tail K7" + layout] = (
            "shard_tail", (merged, n_model, rules[d]._tail),
            {"kr_stride": rules[d]._kr_total}, (True, False))
        pods = [pod_shard.PodShardedKernel(
            compiled, local_mesh(device, n_data, n_model, e))
            for e in range(n_model)]
        for explain in (False, True):
            ekw = {"explain": True} if explain else {}
            merged = torch.stack([kmod.set_chunk(
                p._live, r, p._own.s_lo, n_model, e, *flags,
                t_live=p._own.t_live, **ekw)
                for e, p in enumerate(pods)]).amin(0)
            cases["shard_tail K8" + layout + (" explain" if explain
                                             else "")] = (
                "shard_tail", (merged, n_model, None),
                {"kr_stride": compiled.KR}, (explain,))
        log(f"  K7 {layout}: rule shard {d} of target rows {t_rows} (T "
            f"{int(calls[d][0]['t_role'].shape[0])}), KR_local "
            f"{rules[d]._kr_total // n_model}, {int(r['r_n_ra'].shape[0])} "
            f"rows")
        del rules, pods
    return cases


def host_us(fn, n: int = 200) -> float:
    """Mean host microseconds of ``fn`` over ``n`` calls (host clock),
    after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def host_steps(name: str, args: tuple, kw: dict,
               explain: bool = False) -> dict:
    """A redesigned wrapper's host steps on one call's arguments, in
    microseconds: the whole packing (``pack``; set_chunk's of the live
    rows' views, which ``PodShardedKernel`` cuts once per placement;
    shard_tail's of the tables ``RuleShardedKernel`` packs once, beside
    ``pack_dict``, the same call on a plain dict, and ``tail_tables``,
    the packing once per placement), with ``PARENT`` the parent's
    packing of the same call (``parent_pack``, its set_chunk on the
    whole table as its wrapper did), and the steps the rows program
    added: ``rows_tiles`` (cached per shapes), ``sm_count`` and
    set_chunk's ``live_rows`` (the cut, once per placement, and on the
    views it is handed per call); the tail's ``tail_block``.  The tail
    packs its ``explain`` variant."""
    if name == "shard_tail":
        merge, n_model, tabs = args
        lib = kmod._tail_library()
        mode = shard_ref.MODE_SET if tabs is None else shard_ref.MODE_RULE
        kr = kw.get("kr_stride", 0)
        out = {"pack": host_us(lambda: kmod.pack_shard_tail(
            merge, n_model, tabs, explain, kr)),
            "tail_block": host_us(lambda: kmod.tail_block(lib, mode))}
        if tabs is not None:
            plain = dict(tabs)
            out["pack_dict"] = host_us(lambda: kmod.pack_shard_tail(
                merge, n_model, plain, explain, kr))
            out["tail_tables"] = host_us(lambda: kmod.TailTables(plain))
        if PARENT is not None:
            ptabs = None if tabs is None else dict(tabs)
            out["parent_pack"] = host_us(lambda: PARENT.pack_shard_tail(
                merge, n_model, ptabs, explain, kr))
        return out
    c, r = args[0], args[1]
    dev = r["r_n_ra"].device
    mode = kmod.MODE_DENSE

    def pack(mod, table):
        if name == "decide_dense":
            return mod.pack_args(table, r)
        if name == "rule_chunk":
            return mod.pack_chunk_args("rule_chunk", shard_ref.MODE_RULE,
                                       table, *args[1:6])
        return mod.pack_chunk_args(
            "set_chunk", shard_ref.MODE_SET, table, r, args[2],
            table["rule_valid"].shape[2], args[3], args[4])

    if name == "set_chunk":
        live = shard_ref.live_rows(c, kw["t_live"])
        out = {"pack": host_us(lambda: pack(kmod, live)),
               "live_rows": host_us(
                   lambda: shard_ref.live_rows(c, kw["t_live"])),
               "live_rows_per_call": host_us(
                   lambda: shard_ref.live_rows(live, kw["t_live"]))}
        lib, mode, table = kmod._chunk_library(), shard_ref.MODE_SET, live
    else:
        out = {"pack": host_us(lambda: pack(kmod, c))}
        lib, table = kmod._dense_library(), c
        if name == "rule_chunk":
            lib, mode = kmod._chunk_library(), shard_ref.MODE_RULE
    if PARENT is not None:
        out["parent_pack"] = host_us(lambda: pack(PARENT, c))
    shape = pack(kmod, table).shape
    out["rows_tiles"] = host_us(
        lambda: kmod.rows_tiles(lib, shape, False, kmod._sm_count(dev),
                                mode))
    out["sm_count"] = host_us(lambda: kmod._sm_count(dev))
    return out


def cell_shape(name: str, args: tuple, kw: dict) -> dict:
    """A report cell's rows and block shape: the rows program's ``RT`` /
    ``PT`` (with its target rows ``T``), the tail's threads and rows per
    block."""
    if name == "shard_tail":
        mode = shard_ref.MODE_SET if args[2] is None else shard_ref.MODE_RULE
        block = kmod.tail_block(kmod._tail_library(), mode)
        return {"rows": int(args[0].shape[0]), "threads": block["threads"],
                "rows_per_block": block["rows"]}
    if name == "decide_dense":
        shape = kmod.pack_args(args[0], args[1]).shape
    elif name == "rule_chunk":
        shape = kmod.pack_chunk_args("rule_chunk", shard_ref.MODE_RULE,
                                     *args[:6]).shape
    else:
        live = shard_ref.live_rows(args[0], kw["t_live"])
        shape = kmod.pack_chunk_args(
            "set_chunk", shard_ref.MODE_SET, live, args[1], args[2],
            args[0]["rule_valid"].shape[2], args[3], args[4]).shape
    return {"rows": shape["B"], "T": shape["T"], "RT": shape["RT"],
            "PT": shape["PT"]}


def ptx_name(name: str, args: tuple, explain: bool) -> str:
    """The ptxas entry of a report cell's kernel instantiation."""
    if name == "shard_tail":
        mode = shard_ref.MODE_SET if args[2] is None else shard_ref.MODE_RULE
        return f"shard_tail_kernel<{mode},{int(explain)}>"
    flags = ",".join(str(int(f)) for f in args[-3:])
    if name == "rule_chunk":
        return f"rule_chunk_kernel<{flags}>"
    return f"{name}_kernel<{flags},{int(explain)}>"


def tail_floor_ms(args: tuple) -> float:
    """The tail's launch floor: the empty kernel of
    ``acs_shard_tail_floor`` over the grid the call's launch takes, the
    median window of ``time_steady``."""
    lib = kmod._tail_library()
    mode = shard_ref.MODE_SET if args[2] is None else shard_ref.MODE_RULE
    threads = kmod.tail_block(lib, mode)["threads"]
    rows = int(args[0].shape[0])
    stream = torch.cuda.current_stream().cuda_stream

    def floor():
        if lib.acs_shard_tail_floor(mode, rows, threads, stream) != 0:
            raise RuntimeError("acs_shard_tail_floor failed")
    return time_steady(floor)[0]


def rows_report(cases: dict, ptx: dict, card: str, stats: dict) -> dict:
    """The report of the rows program's kernels and the tail: each
    main-path call of ``cases`` held against its plain version (each
    explain flag), then through the wrapper and packed once (with
    ``--parent-csrc`` beside the parent's kernel on the same arguments,
    both ways), explain on and off where the cell has both, its plain
    version's time, bound (``set_chunk``: over the live target rows)
    beside the yardstick of the design before (the stage-A fold on every
    pair of the whole table; the tail: its launch floor, an empty kernel
    over the same grid), the wrapper's host steps (``host_steps``),
    ptxas numbers, blocks per SM and block shape; returns the times by
    cell."""
    out = {}
    for cell, (name, args, kw, explains) in cases.items():
        for e in explains:
            ekw = {**kw, "explain": True} if e else kw
            _checked(name + ("+explain" if e else ""), stats,
                     getattr(kmod, name)(*args, **ekw),
                     PLAIN[name](*args, **ekw))
        t = redesigned_times(name, args, explains, kw)
        ekw = {**kw, "explain": True} if explains[0] else kw
        t["plain_ms"] = time_ms(lambda: PLAIN[name](*args, **ekw), 1)
        res = getattr(kmod, name)(*args, **ekw)
        if name == "decide_dense":
            t["bound_ms"], t["bound_by"], _, t["ops"] = bound_ms(
                args[0], args[1], args[-1])
            t["yardstick_ms"], _, _, t["ops_yardstick"] = bound_ms(
                args[0], args[1], args[-1], every_pair=True)
        elif name == "shard_tail":
            t["bound_ms"], t["bound_by"], _, t["ops"] = bound_tail(
                args[0], args[2], res)
            t["floor_ms"] = tail_floor_ms(args)
        else:
            table = args[0] if name == "rule_chunk" else shard_ref.live_rows(
                args[0], kw["t_live"])
            t["bound_ms"], t["bound_by"], _, t["ops"] = bound_chunk(
                table, args[1], args[-3:], res)
            t["yardstick_ms"], _, _, t["ops_yardstick"] = bound_chunk(
                args[0], args[1], args[-3:], res, every_pair=True)
        t.update(cell_shape(name, args, kw),
                 host_us=host_steps(name, args, kw, explains[0]))
        if name != "shard_tail":
            t["flags"] = [bool(f) for f in args[-3:]]
        t["ptxas"] = {e: ptx.get(ptx_name(name, args, e)) for e in explains}
        out[cell] = t
        log(f"  {name} {cell} on {card}: " + json.dumps(t))
        for i, e in enumerate(explains):
            sfx = "_explain_off" if i else ""
            line = (f"    explain {'on' if e else 'off'}: wrapper "
                    f"{t['ms' + sfx]:.4f} ms, packed once "
                    f"{t['kernel_ms' + sfx]:.4f} ms")
            if "parent_kernel_ms" + sfx in t:
                pk = t["parent_kernel_ms" + sfx]
                line += (f"; parent wrapper {t['parent_ms' + sfx]:.4f} ms, "
                         f"packed once {pk:.4f} ms "
                         f"({pk / t['kernel_ms' + sfx]:.2f}x)")
            if "floor_ms" in t:
                line += (f"; launch floor {t['floor_ms']:.4f} ms "
                         f"({t['kernel_ms' + sfx] / t['floor_ms']:.2f}x)")
            log(f"{line}; bound {t['bound_ms']:.5f} ms; PERF.md before: "
                f"{old_ms(name, cell, e)} ms")
    return out


def old_ms(name: str, cell: str, explain: bool) -> str:
    """The time PERF.md records for a report cell's design before."""
    if explain:
        return OLD_MS[(name, "explain")]
    if cell.startswith("K6"):
        return OLD_MS[(name, "K6 (4,1)")]
    return OLD_MS[(name, cell.replace(name, "").strip())]


# ---------------------------------------- the plane kernels (K2 and K5)


def planes_cases(sig: dict, rel: dict, wia: dict, wl: dict, lat: dict
                 ) -> dict:
    """The plane kernels' main-path calls, by cell: ``sig_planes`` at (a)
    and (b) (phase 7's first batches) and at relation-720 (phase 12's
    unscoped call) in all four (with_hr, with_rel) variants, the flags
    replaced on the same tables; ``wia_planes`` at 100k (phase 9), the
    lattice's warm sweep (phase 11) and wia-large (phase 10)."""
    cases = {"sig_planes (a)": ("sig_planes", sig["planes_args"]["a"],
                                None),
             "sig_planes (b)": ("sig_planes", sig["planes_args"]["b"],
                                None)}
    base = rel["sig_planes"][:3]
    for h in (False, True):
        for r in (False, True):
            cases[f"sig_planes relation-720 ({int(h)},{int(r)})"] = (
                "sig_planes", base + (h, r), None)
    for cell, src, args in (("100k", wia, wia["100k"]),
                            ("lattice", lat, lat["args"]),
                            ("wia-large", wl, wl["args"])):
        cases["wia_planes " + cell] = ("wia_planes", args, src["t_rows"])
    return cases


def planes_shape(name: str, args: tuple) -> dict:
    """A plane kernel cell's shapes and block shape: K2's groups, target
    rows, rule positions and threads; K5's rows, target rows, TT target
    rows per tile and RB rows per block (the library's) and threads."""
    if name == "sig_planes":
        tabs = args[0]
        G, S, KP, KR = (int(x) for x in tabs["rule_effect"].shape)
        return {"G": G, "T": int(tabs["t_role"].shape[1]),
                "positions": G * S * KP * KR,
                "threads": kmod.SIG_PLANES_THREADS}
    _, _, dims, threads = kmod.pack_wia_planes(*args)
    d = dict(zip(kmod.WIA_PLANES_DIMS, dims))
    return {"N": d["N"], "T": d["T"], "TT": d["TT"], "RB": d["RB"],
            "threads": threads}


def planes_ptx(name: str, args: tuple, ptx: dict) -> dict:
    """The ptxas entries of a plane kernel cell's instantiations."""
    if name == "wia_planes":
        keys = ("wia_rows_kernel", "wia_planes_kernel")
    else:
        flags = ",".join(str(int(f)) for f in args[-2:])
        keys = (f"sig_planes_comp_kernel<{flags}>",
                f"sig_planes_kernel<{flags}>")
    return {k: ptx.get(k) for k in keys}


def planes_report(cases: dict, ptx: dict, card: str, stats: dict) -> dict:
    """The report of K2 and K5 at their main-path calls: each call held
    against its plain version, then through the wrapper and packed once
    (with ``--parent-csrc`` beside the parent's kernel on the same
    arguments, in turns, and the wrappers in turns), its launch floor (an
    empty kernel over the same grids: K2's two launches, K5's one), its
    plain version's time, bound (K2's beside the yardstick of PRs 2-10,
    every stacked table read), the wrapper's host packing, ptxas numbers,
    blocks per SM and block shape; returns the times by cell."""
    out = {}
    for cell, (name, args, t_rows) in cases.items():
        plain = PLANES_PLAIN[name]
        _checked(name, stats, getattr(kmod, name)(*args), plain(*args))
        t = redesigned_times(name, args)
        t["plain_ms"] = time_ms(lambda: plain(*args), 1)
        floor = getattr(kmod, name + "_floor")(*args)
        t["floor_ms"] = time_steady(floor)[0]
        pack = getattr(kmod, "pack_" + name)
        t["pack_us"] = host_us(lambda: pack(*args), 50)
        if PARENT is not None:
            ppack = getattr(PARENT, "pack_" + name)
            t["parent_pack_us"] = host_us(lambda: ppack(*args), 50)
        if name == "sig_planes":
            res = kmod.sig_planes(*args)
            t["bound_ms"], t["bound_by"], t["bytes"], t["ops"] = \
                bound_sig_planes(*args, res)
            t["yardstick_ms"], _, t["bytes_yardstick"], _ = \
                bound_sig_planes(*args, res, every_table=True)
            t["flags"] = [bool(f) for f in args[-2:]]
            del res
        else:
            t["bound_ms"], t["bound_by"], t["bytes"], t["ops"] = \
                bound_wia_planes(args, t_rows)
        t.update(planes_shape(name, args))
        t["ptxas"] = planes_ptx(name, args, ptx)
        out[cell] = t
        log(f"  {cell} on {card}: " + json.dumps(t))
        line = (f"    wrapper {t['ms']:.4f} ms, packed once "
                f"{t['kernel_ms']:.4f} ms; launch floor {t['floor_ms']:.4f} "
                f"ms ({t['kernel_ms'] / t['floor_ms']:.2f}x)")
        if "parent_kernel_ms" in t:
            pk = t["parent_kernel_ms"]
            line += (f"; parent wrapper {t['parent_ms']:.4f} ms, packed "
                     f"once {pk:.4f} ms ({pk / t['kernel_ms']:.2f}x); "
                     f"wrappers in turns {t['wrapper_steady_ms']:.4f} / "
                     f"{t['parent_wrapper_steady_ms']:.4f} ms")
        key = cell.split(" ", 1)[1].split(" (")[0] if "relation" in cell \
            else cell.split(" ", 1)[1]
        log(f"{line}; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"packed once {t['kernel_ms'] / t['bound_ms']:.1f}x the bound; "
            f"{t['blocks_per_sm']} blocks per SM; PERF.md before: "
            f"{OLD_MS[(name, key)]} ms")
    return out


# ------------------------------- phases 19-21: the serving front half

SERVE_RULES = 20_000   # bench_serving_e2e's tree (with the seed data)
SERVE_ROWS = 8192
WIRE_BATCHES = 8
DEEP_ROWS = 16         # rows past the floor caps in phase 19's extra batch
FRONT_RULES = 10_000   # bench_token_mix's and bench_adapter_mixed_warm's
FRONT_ROWS = 8192
TOKENS = 512
FRONT_PASSES = 4       # the benches' 32,768 rows / 8,192
WARM_HIT_PASSES = 16


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | 0x80 if n else low)
        if not n:
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """One length-delimited protobuf field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _attribute_bytes(attr) -> bytes:
    """``acstpu.Attribute``: id = 1, value = 2, attributes = 3."""
    out = b""
    if attr.id:
        out += _field(1, attr.id.encode())
    if attr.value:
        out += _field(2, attr.value.encode())
    for sub in attr.attributes or []:
        out += _field(3, _attribute_bytes(sub))
    return out


def wire_bytes(request) -> bytes:
    """The serialized ``acstpu.Request`` of ``request``, written from
    ``proto/access_control.proto``'s field numbers (Request: target 1,
    context 2; Target: subjects 1, resources 2, actions 3; Context:
    subject 1, resources 2, security 3, each a ContextValue whose
    ``value`` (2) holds the entry's JSON text), so this script makes wire
    bytes without protobuf.  ``tests/test_torch_wire.py`` holds them equal
    to the JAX package's ``request_to_pb(request).SerializeToString()``."""
    out = b""
    target = request.target
    if target is not None:
        out += _field(1, b"".join(
            _field(number, _attribute_bytes(a))
            for number, side in ((1, target.subjects),
                                 (2, target.resources), (3, target.actions))
            for a in side))
    ctx = request.context
    if ctx is not None:
        body = b""
        if ctx.get("subject") is not None:
            body += _field(1, _field(2, json.dumps(ctx["subject"]).encode()))
        for res in ctx.get("resources") or []:
            body += _field(2, _field(2, json.dumps(res).encode()))
        if ctx.get("security") is not None:
            body += _field(3, _field(2, json.dumps(ctx["security"]).encode()))
        if body:
            out += _field(2, body)
    return out


def host_tools() -> dict:
    """``g++ --version``'s first line (the native encoder's compiler) and
    whether ``google.protobuf`` imports (nothing here needs it)."""
    proc = subprocess.run(["g++", "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    try:
        from access_control_srv_tpu_torch.srv.gen import access_control_pb2
    except ImportError as err:
        return {"gxx": proc.stdout.splitlines()[0], "protobuf": None,
                "protobuf_error": str(err)}
    import google.protobuf

    return {"gxx": proc.stdout.splitlines()[0],
            "protobuf": google.protobuf.__version__,
            "pb": access_control_pb2}


def check_wire_with_pb(pb, messages: list[bytes]) -> None:
    """With protobuf present: every written message parses as an
    ``acstpu.Request`` and serializes back to the same bytes."""
    for i, m in enumerate(messages):
        if pb.Request.FromString(m).SerializeToString() != m:
            raise AssertionError(f"wire row {i}: the writer's bytes are not "
                                 "protobuf's serialization")


def serve_engine(n_rules: int) -> AccessController:
    """The JAX package's ``bench_serving_e2e`` tree: the seed data plus
    ``stress_doc(n_rules)``'s policy set (the bench upserts those rules
    into a worker seeded with the same data)."""
    engine = engine_for("seed_data")
    for ps in load_policy_sets(stress_doc(n_rules)):
        engine.update_policy_set(ps)
    return engine


def deep_hr_rows(n: int, seed: int) -> list[Request]:
    """``stress_traffic`` rows whose HR tree flattens to 64 pairs, past
    the floor caps' 32: the wire path encodes them over cap and
    re-encodes them at ``_CAPS_CEIL``."""
    rows = stress_traffic(n, seed=seed)
    for r in rows:
        sub = r.context["subject"]
        sub["hierarchical_scopes"] = [{
            "id": "org-0", "role": sub["role_associations"][0]["role"],
            "children": [{"id": f"org-{i}"} for i in range(1, 64)]}]
    return rows


def _row_key(dec, cach, status, b: int) -> tuple:
    return (int(dec[b]), None if cach[b] < 0 else bool(cach[b]),
            int(status[b]))


def _resp_key(resp) -> tuple:
    return (DEC_CODE[resp.decision], resp.evaluation_cacheable,
            resp.operation_status.code)


def wire_check(label: str, evaluator, engine, requests, messages, expect,
               stats: dict, dense: bool = False, always=()) -> dict:
    """One wire batch: counts to 0, ``is_allowed_batch_wire`` with every
    kernel call held against its plain version, counts read; every
    eligible row's (decision, cacheable, status) equal to
    ``is_allowed_batch`` on the same Request objects, 32 sampled eligible
    rows (and every row of ``always``) equal to the oracle."""
    if not evaluator.native_active:
        raise AssertionError(f"{label}: the native encoder is not active")
    (batch, dec, cach, status), launches, _ = checked_call(
        label, lambda: evaluator.is_allowed_batch_wire(messages), expect,
        stats, dense=dense)
    ref = evaluator.is_allowed_batch(clone(requests))
    eligible = np.flatnonzero(batch.eligible)
    for b in eligible:
        if _row_key(dec, cach, status, b) != _resp_key(ref[b]):
            raise AssertionError(
                f"{label} row {b}: wire {_row_key(dec, cach, status, b)} != "
                f"is_allowed_batch {_resp_key(ref[b])}")
    rng = random.Random(3)
    sample = sorted(set(rng.sample(list(eligible), min(32, len(eligible))))
                    | set(always))
    for b, want in zip(sample, oracle_walks(engine, requests, sample)):
        if not batch.eligible[b]:
            raise AssertionError(f"{label} row {b}: not served natively")
        if _row_key(dec, cach, status, b) != _resp_key(want):
            raise AssertionError(
                f"{label} row {b}: wire {_row_key(dec, cach, status, b)} != "
                f"oracle {_resp_key(want)}")
    share = float(batch.eligible.mean())
    log(f"  {label}: {len(messages)} wire rows, {len(eligible)} eligible "
        f"({share:.4f}); launches {launches}; every kernel call equal to "
        f"its plain version; every eligible row equal to is_allowed_batch; "
        f"{len(sample)} sampled rows equal to the oracle")
    return {"launches": launches, "eligible_share": share,
            "overcap": int(batch.overcap.sum()), "batch": batch}


def wire_rates(evaluator, requests, messages,
               batches: int = WIRE_BATCHES) -> dict:
    """Warm ``is_allowed_batch_wire`` decisions/s over ``batches``
    batches (host clock; each ends in the device sync of materialize),
    the same with pooled staging (``reuse=True``, released after the
    result is read), one batch's stage split (native encode, host
    grouping / packing / launch, device wait and readback, the rest by
    difference), and beside them ``is_allowed_batch`` on the same
    requests (``steady_state``)."""
    evaluator.is_allowed_batch_wire(messages)
    t0 = time.perf_counter()
    for _ in range(batches):
        evaluator.is_allowed_batch_wire(messages)
    dt = (time.perf_counter() - t0) / batches
    t0 = time.perf_counter()
    for _ in range(batches):
        batch = evaluator.is_allowed_batch_wire_async(messages, reuse=True)()[0]
        batch.release_staging()
    dt_pooled = (time.perf_counter() - t0) / batches
    encoder, kernel = evaluator._native_encoder, evaluator._kernel
    t0 = time.perf_counter()
    batch = encoder.encode_wire(messages)
    t1 = time.perf_counter()
    thunk = kernel.evaluate_async(batch)
    t2 = time.perf_counter()
    thunk()
    t3 = time.perf_counter()
    stages = {"native_encode": (t1 - t0) * 1e3,
              "group_pack_launch": (t2 - t1) * 1e3,
              "device_wait_readback": (t3 - t2) * 1e3}
    stages["rest"] = dt * 1e3 - sum(stages.values())
    return {"rows": len(messages), "batch_ms": dt * 1e3,
            "decisions_per_s": len(messages) / dt,
            "pooled_decisions_per_s": len(messages) / dt_pooled,
            "stages_ms": stages,
            "is_allowed_batch": steady_state(evaluator, requests)}


def serve_tree(device) -> tuple:
    """Phase 19's serve-20k tree and evaluator: (engine, evaluator,
    seconds to load and compile)."""
    t0 = time.perf_counter()
    engine = serve_engine(SERVE_RULES)
    evaluator = HybridEvaluator(engine, device=device)
    return engine, evaluator, time.perf_counter() - t0


def phase_wire(device, stats: dict, card: str, wire_a, pre=None) -> dict:
    """Phase 19: ``is_allowed_batch_wire`` at ``serve-20k``, at (a) and
    at ``scoped_511`` (the dense path), plus one ``serve-20k`` batch with
    deep-HR rows through the ceiling re-encode."""
    tools = host_tools()
    log(f"  {tools['gxx']}; google.protobuf "
        f"{tools['protobuf'] or 'absent: ' + tools['protobuf_error']}")
    out = {"launches": {}}
    engine, evaluator, secs = pre if pre is not None else serve_tree(device)
    log(f"  serve-20k tree: {evaluator._compiled.n_rules} rules, loaded and "
        f"compiled in {secs:.1f} s")
    # bench_serving_e2e's _serving_batch_msg(8192, default_rng(11),
    # wide=True) is stress_traffic at numpy seed 11 (no context resources)
    reqs = stress_traffic(SERVE_ROWS, seed=11)
    cells = [("serve-20k", evaluator, engine, reqs, False,
              ("sig_planes", "sig_decide"))]
    engine_a, evaluator_a, reqs_a = wire_a
    cells.append(("(a)", evaluator_a, engine_a, reqs_a, False,
                  ("sig_decide",)))
    rng = random.Random(5)
    engine_d = engine_for("scoped_511")
    reqs_d = grid_requests(rng, 4096 - 5, stress=True) + odd_requests(rng,
                                                                      True)
    cells.append(("scoped_511", HybridEvaluator(engine_d, device=device),
                  engine_d, reqs_d, True, ("decide_dense",)))
    for label, ev, eng, rq, dense, expect in cells:
        t0 = time.perf_counter()
        msgs = [wire_bytes(r) for r in rq]
        if tools["protobuf"]:
            check_wire_with_pb(tools["pb"], msgs)
        cell = wire_check(label, ev, eng, rq, msgs, expect, stats,
                          dense=dense)
        cell.pop("batch")
        cell.update(wire_rates(ev, rq, msgs))
        out[label] = cell
        for k in ("decide_dense", "sig_planes", "sig_decide"):
            out["launches"][k] = out["launches"].get(k, 0) \
                + cell["launches"][k]
        py = cell["is_allowed_batch"]
        log(f"  {label} on {card}: wire {cell['decisions_per_s']:.0f} "
            f"decisions/s ({cell['batch_ms']:.3f} ms per batch; pooled "
            f"staging {cell['pooled_decisions_per_s']:.0f}), stages (ms) "
            f"{json.dumps(cell['stages_ms'])}; is_allowed_batch "
            f"{py['decisions_per_s']:.0f} decisions/s ({py['batch_ms']:.3f} "
            f"ms), stages (ms) {json.dumps(py['stages_ms'])}; the wire call "
            f"returns arrays (response framing comes with the transport); "
            f"cell {time.perf_counter() - t0:.1f} s")
    # the ceiling re-encode: DEEP_ROWS rows past the floor caps
    deep = deep_hr_rows(DEEP_ROWS, seed=12)
    rows = list(reqs)
    at = list(range(0, SERVE_ROWS, SERVE_ROWS // DEEP_ROWS))
    for i, r in zip(at, deep):
        rows[i] = r
    msgs = [wire_bytes(r) for r in rows]
    cell = wire_check("serve-20k + deep HR", evaluator, engine, rows, msgs,
                      ("sig_decide",), stats, always=at)
    batch = cell.pop("batch")
    if not (batch.overcap[at].all() and batch.eligible[at].all()):
        raise AssertionError("deep-HR rows did not take the ceiling "
                             "re-encode")
    for k in ("sig_planes", "sig_decide"):
        out["launches"][k] += cell["launches"][k]
    out["deep"] = cell
    log(f"  serve-20k + deep HR: {len(at)} rows over the floor caps, all "
        f"re-encoded at the ceiling and served natively; launches "
        f"{cell['launches']}")
    return out


def token_mix_setup(n_rules: int, rows: int, n_tokens: int,
                    seed: int = 29):
    """The JAX package's ``bench_token_mix``: ``stress_doc(n_rules)``,
    rows over ``n_tokens`` tokens whose subjects arrive as bare tokens,
    ``StaticIdentityClient`` behind ``CachingIdentityClient(ttl_s=3600)``
    and ``HRScopeProvider(SubjectCache())``."""
    engine = engine_from_doc(stress_doc(n_rules))
    ids = StaticIdentityClient()
    subject_cache = SubjectCache()
    rng = np.random.default_rng(seed)
    roles = []
    for t in range(n_tokens):
        role = f"role-{int(rng.integers(108))}"
        roles.append(role)
        ids.register(f"tok-{t}", {
            "id": f"user-{t}",
            "tokens": [{"token": f"tok-{t}", "interactive": True}],
            "role_associations": [{"role": role, "attributes": []}],
        })
        subject_cache.set(f"cache:user-{t}:hrScopes", [])
    identity = CachingIdentityClient(ids, ttl_s=3600.0)
    engine.identity_client = identity
    engine.hr_scope_provider = HRScopeProvider(subject_cache)
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    requests = []
    for i in range(rows):
        t = int(rng.integers(n_tokens))
        k = int(rng.integers(72))
        requests.append(Request(
            target=Target(
                subjects=[Attribute(id=URNS["role"], value=roles[t]),
                          Attribute(id=URNS["subjectID"], value=f"user-{t}")],
                resources=[
                    Attribute(id=URNS["entity"],
                              value=f"urn:restorecommerce:acs:model:"
                                    f"stress{k}.Stress{k}"),
                    Attribute(id=URNS["resourceID"], value=f"res-{i}")],
                actions=[Attribute(id=URNS["actionID"],
                                   value=actions[i % 4])],
            ),
            context={"resources": [], "subject": {"token": f"tok-{t}"}},
        ))
    return engine, requests, identity


def reset_prepared(requests) -> None:
    """Each timed pass pays the token / HR preparation again (warm
    caches), as ``bench_token_mix`` resets the flags."""
    for r in requests:
        r._context_prepared = False
        r._token_resolved = False


def batch_split(evaluator, requests, prepare: bool = False) -> dict:
    """One ``is_allowed_batch``'s host stages: token / HR preparation
    (with ``prepare``), encode, grouping / packing / launch, device wait
    and readback, decode."""
    if prepare:
        reset_prepared(requests)
    t0 = time.perf_counter()
    evaluator.prepare_batch(requests)
    t1 = time.perf_counter()
    batch = encode_requests(requests, evaluator._compiled,
                            evaluator.engine.resource_adapter)
    t2 = time.perf_counter()
    thunk = evaluator._kernel.evaluate_async(batch)
    t3 = time.perf_counter()
    out = thunk()
    t4 = time.perf_counter()
    evaluator._decode_batch(requests, batch, out)
    t5 = time.perf_counter()
    return {"prepare": (t1 - t0) * 1e3, "encode": (t2 - t1) * 1e3,
            "group_pack_launch": (t3 - t2) * 1e3,
            "device_wait_readback": (t4 - t3) * 1e3,
            "decode_oracle_rows": (t5 - t4) * 1e3}


def token_mix_tree(device, n_rules: int = FRONT_RULES,
                   rows: int = FRONT_ROWS, n_tokens: int = TOKENS) -> tuple:
    """Phase 20's host work: ``token_mix_setup`` and the evaluator."""
    engine, requests, identity = token_mix_setup(n_rules, rows, n_tokens)
    return engine, requests, identity, HybridEvaluator(engine,
                                                       device=device)


def phase_token_mix(device, stats: dict, card: str, pre: tuple) -> dict:
    """Phase 20, ``token-mix``: token traffic through ``prepare_batch``;
    eligible share, sampled responses against the oracle (which resolves
    the token itself), decisions/s with the preparation in every pass.
    ``pre``: ``token_mix_tree``'s result, built earlier."""
    import gc

    engine, requests, identity, evaluator = pre
    rows, n_tokens = len(requests), TOKENS
    fresh = clone(requests)
    responses, launches, _ = checked_call(
        "token-mix", lambda: evaluator.is_allowed_batch(requests),
        ("sig_decide",), stats)
    n = sample_oracle(engine, fresh, responses)
    batch = encode_requests(requests, evaluator._compiled)
    share = float(batch.eligible.mean())
    if share < 0.99:
        raise AssertionError(f"token-mix eligible share {share} < 0.99 "
                             f"({batch.ineligible_reasons})")
    gc.collect()
    t0 = time.perf_counter()
    for _ in range(FRONT_PASSES):
        reset_prepared(requests)
        evaluator.is_allowed_batch(requests)
    dt = (time.perf_counter() - t0) / FRONT_PASSES
    out = {"rows": rows, "tokens": n_tokens, "launches": launches,
           "eligible_share": share, "batch_ms": dt * 1e3,
           "decisions_per_s": rows / dt,
           "resolution_hit_ratio": identity.cache_stats()["hit_ratio"],
           "stages_ms": batch_split(evaluator, requests, prepare=True)}
    log(f"  token-mix: {rows} rows over {n_tokens} tokens; launches "
        f"{launches}; every kernel call equal to its plain version; {n} "
        f"sampled responses equal to the oracle; eligible share "
        f"{share:.4f}")
    log(f"  token-mix on {card}: {out['decisions_per_s']:.0f} decisions/s "
        f"({out['batch_ms']:.3f} ms per batch, preparation included), "
        f"stages (ms) {json.dumps(out['stages_ms'])}")
    return out


class StubAdapter:
    """``bench_adapter_mixed``'s adapter: every context query returns one
    row."""

    def query(self, context_query, request):
        return [{"id": "res"}]


def adapter_mixed_setup(n_rules: int, rows: int, seed: int = 23):
    """The JAX package's ``_adapter_mixed_setup(cacheable=True)``:
    ``stress_doc(n_rules, cacheable=True)`` plus 8 context-query rules
    (entities 56-63, a condition on the query result), the stub adapter,
    rows drawn uniformly over the 64 entities."""
    engine = engine_from_doc(stress_doc(n_rules, cacheable=True))
    cq = []
    for k in range(56, 64):
        entity = f"urn:restorecommerce:acs:model:stress{k}.Stress{k}"
        cq.append({"id": f"cqp{k}", "combining_algorithm": PO, "rules": [{
            "id": f"cqr{k}",
            "target": {"resources": [{"id": URNS["entity"], "value": entity}],
                       "actions": []},
            "effect": "PERMIT",
            "context_query": {
                "filters": [{"field": "id", "operation": "eq",
                             "value": f"res-{k}"}],
                "query": "query q { all { id } }"},
            "condition": "len(context._queryResult) > 0",
            "evaluation_cacheable": True,
        }]})
    for ps in load_policy_sets({"policy_sets": [
            {"id": "cq", "combining_algorithm": DO, "policies": cq}]}):
        engine.update_policy_set(ps)
    engine.resource_adapter = StubAdapter()
    rng = np.random.default_rng(seed)
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    requests = []
    for i in range(rows):
        role = f"role-{int(rng.integers(108))}"
        k = int(rng.integers(64))
        requests.append(Request(
            target=Target(
                subjects=[Attribute(id=URNS["role"], value=role),
                          Attribute(id=URNS["subjectID"], value=f"u{i}")],
                resources=[
                    Attribute(id=URNS["entity"],
                              value=f"urn:restorecommerce:acs:model:"
                                    f"stress{k}.Stress{k}"),
                    Attribute(id=URNS["resourceID"], value=f"res-{i}")],
                actions=[Attribute(id=URNS["actionID"],
                                   value=actions[i % 4])],
            ),
            context={"resources": [], "subject": {
                "id": f"u{i}",
                "role_associations": [{"role": role, "attributes": []}],
                "hierarchical_scopes": []}},
        ))
    return engine, requests


def adapter_tree(device, n_rules: int = FRONT_RULES,
                 rows: int = FRONT_ROWS) -> tuple:
    """Phase 21's host work: ``adapter_mixed_setup`` and the evaluator
    with its (empty) decision cache."""
    engine, requests = adapter_mixed_setup(n_rules, rows)
    cache = DecisionCache(ttl_s=3600.0, max_entries=1 << 17)
    return engine, requests, cache, HybridEvaluator(
        engine, device=device, decision_cache=cache)


def phase_adapter_warm(device, stats: dict, card: str, pre: tuple) -> dict:
    """Phase 21, ``adapter-mixed-warm``: a cold pass writes the decision
    cache through; a warm pass's hits equal the cold responses; warm
    decisions/s of the hit rows alone and of the mixed traffic.  ``pre``:
    ``adapter_tree``'s result, built earlier."""
    import gc

    engine, requests, cache, evaluator = pre
    rows = len(requests)
    fresh = clone(requests)
    cold, launches, _ = checked_call(
        "adapter-mixed-warm", lambda: evaluator.is_allowed_batch(requests),
        ("sig_decide",), stats)
    n = sample_oracle(engine, fresh, cold)
    cacheable = [b for b, r in enumerate(cold)
                 if r.evaluation_cacheable is True]
    hits0 = cache.stats()["hits"]
    warm = evaluator.is_allowed_batch(clone(fresh))
    if cache.stats()["hits"] - hits0 != len(cacheable):
        raise AssertionError("warm pass: not every cacheable row hit")
    for b in cacheable:
        if response_key(warm[b]) != response_key(cold[b]):
            raise AssertionError(f"warm hit {b} != its cold response")
    gc.collect()
    t0 = time.perf_counter()
    for _ in range(FRONT_PASSES):
        evaluator.is_allowed_batch(requests)
    dt_mixed = (time.perf_counter() - t0) / FRONT_PASSES
    hit_rows = [requests[b] for b in cacheable]
    hits0 = cache.stats()["hits"]
    gc.collect()
    t0 = time.perf_counter()
    for _ in range(WARM_HIT_PASSES):
        evaluator.is_allowed_batch(hit_rows)
    dt_hits = (time.perf_counter() - t0) / WARM_HIT_PASSES
    if cache.stats()["hits"] - hits0 != len(hit_rows) * WARM_HIT_PASSES:
        raise AssertionError("warm cacheable rows must all hit")
    # one warm mixed batch's split: the batch-wide lookup, then the
    # uncached path over the misses
    subject_urn = engine.urns.get("subjectID") or ""
    t0 = time.perf_counter()
    misses = [r for r in requests
              if cache.get(cache.fingerprint(r, subject_urn)) is None]
    t1 = time.perf_counter()
    evaluator._uncached_async(misses)()
    t2 = time.perf_counter()
    st = cache.stats()
    out = {"rows": rows, "launches": launches,
           "cacheable_rows": len(cacheable), "cache": {
               k: st[k] for k in ("hits", "misses", "entries", "hit_ratio")},
           "hit_rows_decisions_per_s": len(hit_rows) / dt_hits,
           "mixed_decisions_per_s": rows / dt_mixed,
           "mixed_batch_ms": dt_mixed * 1e3,
           "stages_ms": {"cache_lookup": (t1 - t0) * 1e3,
                         "miss_rows": (t2 - t1) * 1e3, "miss_count":
                         len(misses)}}
    log(f"  adapter-mixed-warm: {rows} rows; launches {launches}; every "
        f"kernel call equal to its plain version; {n} sampled cold "
        f"responses equal to the oracle; {len(cacheable)} cacheable rows, "
        f"every warm hit equal to its cold response; cache {out['cache']}")
    log(f"  adapter-mixed-warm on {card}: hit rows "
        f"{out['hit_rows_decisions_per_s']:.0f} decisions/s, mixed warm "
        f"traffic {out['mixed_decisions_per_s']:.0f} decisions/s "
        f"({out['mixed_batch_ms']:.3f} ms per batch), stages (ms) "
        f"{json.dumps(out['stages_ms'])}")
    return out


# --------------------------------------------- phase 22: the gRPC main path

GRPC_UNARY_CALLERS = 64
GRPC_UNARY_CALLS = 1024
# the unary cells: the deployed window (cfg/config.json, 2 ms), then a
# worker started with the shipped ``unary`` overlay
# (cfg/config_unary.json, 10 ms).  A collection under
# ``min_kernel_batch`` (8) rows takes the single-request path, the
# oracle, one row at a time.
GRPC_UNARY_ENV = "unary"
GRPC_STREAM_FRAMES = 4
GRPC_WIA_QUERIES = 64
GRPC_WIA_UNARY = 16
GRPC_CONCURRENT = 4
GRPC_FLIP_ROWS = 64
GRPC_FLIP_TIMEOUT_S = 300.0
# bench_all._SERVE_OBSERVABILITY: stage histograms on, span sampling off
SERVE_OBSERVABILITY = {"observability:enabled": True,
                       "observability:tracing:enabled": True,
                       "observability:tracing:sample_rate": 0.0}
# the serving shell's fallback sites (their rows answered another way)
GRPC_ERROR_KEYS = ("native-wire-error", "stream-wire-error",
                   "stream-wire-timeout", "batch-prepare-error",
                   "batch-dispatch-error", "batch-finalize-error",
                   "batch-eval-error", "wia-batch-error")


def error_counts(paths: dict) -> dict:
    """The non-zero counts of the fallback sites and of the device
    path's refusals (``hang-fallback-*``, ``*-degraded``)."""
    return {k: v for k, v in paths.items()
            if v and (k in GRPC_ERROR_KEYS or k.startswith("hang-fallback")
                      or k.endswith("-degraded"))}
AC_RPC = "/acstpu.AccessControlService/"
RC_AC_RPC = "/io.restorecommerce.access_control.AccessControlService/"


# the unary callers run in a process of their own (as remote clients
# would): in the server's process their threads would hold the
# interpreter lock the handlers need, and arrivals would spread too thin
# for the micro-batcher's window.  Arguments: address, method path,
# callers, the file of length-prefixed request bytes, the result file.
UNARY_CLIENT = r"""
import struct, sys, threading, time
from concurrent.futures import ThreadPoolExecutor
import grpc
addr, path, callers, src, dst = sys.argv[1:6]
callers = int(callers)
with open(src, "rb") as fh:
    data = fh.read()
msgs, i = [], 0
while i < len(data):
    (n,) = struct.unpack_from("<I", data, i)
    msgs.append(data[i + 4:i + 4 + n])
    i += 4 + n
channel = grpc.insecure_channel(addr)
rpc = channel.unary_unary(path)
barrier = threading.Barrier(callers)
out = [None] * len(msgs)
def run(k):
    barrier.wait(timeout=120)
    for j in range(k, len(msgs), callers):
        t = time.perf_counter()
        resp = rpc(msgs[j], timeout=600)
        out[j] = (resp, time.perf_counter() - t)
t0 = time.perf_counter()
with ThreadPoolExecutor(callers) as pool:
    list(pool.map(run, range(callers)))
wall = time.perf_counter() - t0
channel.close()
with open(dst, "wb") as fh:
    fh.write(struct.pack("<d", wall))
    for resp, dt in out:
        fh.write(struct.pack("<dI", dt, len(resp)) + resp)
"""


def unary_calls_elsewhere(addr: str, path: str, messages: list[bytes],
                          callers: int) -> tuple[list, float]:
    """``messages`` as unary calls from ``callers`` threads of another
    process, started together; returns ([(response bytes, round-trip
    s)], wall s)."""
    import struct

    tmp = tempfile.mkdtemp(prefix="acs-unary-")
    try:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        with open(src, "wb") as fh:
            for m in messages:
                fh.write(struct.pack("<I", len(m)) + m)
        subprocess.run([sys.executable, "-c", UNARY_CLIENT, addr, path,
                        str(callers), src, dst], check=True, timeout=900)
        with open(dst, "rb") as fh:
            data = fh.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (wall,) = struct.unpack_from("<d", data, 0)
    out, i = [], 8
    while i < len(data):
        dt, n = struct.unpack_from("<dI", data, i)
        out.append((data[i + 12:i + 12 + n], dt))
        i += 12 + n
    return out, wall


def store_docs(doc) -> tuple[list, list, list]:
    """(policy sets, policies, rules) of a nested ``policy_sets``
    document as the policy store keeps them, children referenced by id:
    what the JAX ``bench_serving_e2e`` upserts into its seeded worker."""
    sets, policies, rules = [], [], []
    for ps in doc["policy_sets"]:
        sets.append({**{k: v for k, v in ps.items() if k != "policies"},
                     "policies": [p["id"] for p in ps["policies"]]})
        for pol in ps["policies"]:
            policies.append({**{k: v for k, v in pol.items()
                                if k != "rules"},
                             "rules": [r["id"] for r in pol["rules"]]})
            rules.extend(clone(pol["rules"]))
    return sets, policies, rules


def batch_envelope(messages: list[bytes]) -> bytes:
    """``acstpu.BatchRequest`` bytes: each request one field-1 frame."""
    return b"".join(_field(1, m) for m in messages)


def serving_worker(device, env: str = ""):
    """The JAX ``bench_serving_e2e`` worker: ``cfg/config.json`` (with
    its ``cfg/config_<env>.json`` overlay when ``env`` names one), the
    seed data through the store, ``stress_doc(SERVE_RULES)`` upserted
    into it and compiled (the store's refresh, on the compile thread
    where the config says so, awaited), stage histograms on."""
    from access_control_srv_tpu_torch.srv.config import Config
    from access_control_srv_tpu_torch.srv.worker import Worker

    seed = os.path.join(REPO, "data", "seed_data")
    cfg = Config.load(os.path.join(REPO, "cfg"), env=env)
    cfg.set("policies:type", "database")
    cfg.set("seed_data", {k: os.path.join(seed, f"{k}.yaml")
                          for k in ("policy_sets", "policies", "rules")})
    for path, value in SERVE_OBSERVABILITY.items():
        cfg.set(path, value)
    worker = Worker().start(cfg, device=device)
    try:
        worker.store.seed(*store_docs(stress_doc(SERVE_RULES)))
        await_compile(worker.evaluator)
    except BaseException:
        worker.stop()
        raise
    return worker


def await_compile(ev, timeout_s: float = GRPC_FLIP_TIMEOUT_S) -> None:
    """Wait until ``ev`` publishes its latest version with no compile
    pending (the debounced compile thread idle)."""
    t0 = time.perf_counter()
    while True:
        with ev._compile_state_lock:
            idle = not ev._compile_pending and (
                ev._compile_thread is None
                or not ev._compile_thread.is_alive())
        with ev._lock:
            if idle and ev._compiled is not None \
                    and ev._compiled.version == ev._version:
                return
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError("the policy compile never published")
        time.sleep(0.002)


def unary_cell(worker, addr: str, messages: list[bytes], card: str,
               label: str) -> dict:
    """``messages`` as unary ``IsAllowed`` calls from
    ``GRPC_UNARY_CALLERS`` callers in another process through
    ``worker``'s micro-batcher: the launch counts set to 0 just before
    and read just after, the rows each path served, the round trip p50 /
    p99 and the calls/s.  Rows of a batch count under ``kernel`` /
    ``oracle``; a collection under ``min_kernel_batch`` rows takes the
    single-request path (the oracle), which counts no path, so its rows
    are the rest.  ``answers`` holds the response bytes."""
    tel = worker.telemetry
    before = tel.paths.snapshot()
    reset_launches()
    results, wall = unary_calls_elsewhere(addr, AC_RPC + "IsAllowed",
                                          messages, GRPC_UNARY_CALLERS)
    launches = dict(kmod.LAUNCHES)
    paths = {k: v - before.get(k, 0)
             for k, v in tel.paths.snapshot().items()
             if v != before.get(k, 0)}
    lat = sorted(t for _, t in results)
    batched = paths.get("kernel", 0) + paths.get("oracle", 0)
    cell = {"calls": len(messages), "callers": GRPC_UNARY_CALLERS,
            "window_ms": worker.cfg.get("evaluator:micro_batch_window_ms"),
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
            "calls_per_s": len(messages) / wall, "launches": launches,
            "batched_rows": batched,
            "single_request_rows": len(messages) - batched
            - paths.get("cache-hit", 0),
            "paths": paths, "answers": [r for r, _ in results]}
    log(f"  unary IsAllowed on {card}, {label}, {cell['window_ms']} ms "
        f"window: {GRPC_UNARY_CALLERS} callers in another process, "
        f"{len(messages)} calls, round trip p50 {cell['p50_ms']:.3f} ms, "
        f"p99 {cell['p99_ms']:.3f} ms, {cell['calls_per_s']:.0f} calls/s; "
        f"{batched} rows in kernel-sized batches, "
        f"{cell['single_request_rows']} on the single-request path; rows "
        f"by path {json.dumps(paths)}; launches {launches}")
    return cell


def stage_breakdown(telemetry) -> dict:
    """``bench_all._stage_breakdown``: per stage the count, total s and
    interpolated p50 / p99 ms of the window since the histograms were
    cleared."""
    out = {}
    for stage, snap in sorted((telemetry.snapshot().get("stages")
                               or {}).items()):
        if snap["count"]:
            out[stage] = {
                "count": snap["count"], "total_s": round(snap["sum_s"], 6),
                "p50_ms": None if snap["p50_s"] is None
                else round(snap["p50_s"] * 1e3, 4),
                "p99_ms": None if snap["p99_s"] is None
                else round(snap["p99_s"] * 1e3, 4)}
    return out


def _pb_key(msg) -> tuple:
    st = msg.operation_status
    return (int(msg.decision), bool(msg.evaluation_cacheable), int(st.code),
            st.message)


def _add_launches(out: dict) -> None:
    for k, v in kmod.LAUNCHES.items():
        out[k] = out.get(k, 0) + v


def phase_grpc(device, stats: dict, card: str, wire_rate: float) -> dict:
    """Phase 22: ``serve-20k`` through the port's own serving shell: a
    ``Worker`` on the card, a ``GrpcServer`` on ``127.0.0.1:0`` and a
    client over loopback (the JAX package's ``bench_serving_e2e``).
    ``wire_rate`` is phase 19's evaluator-wire decisions/s on the same
    rows, printed beside the RPC's."""
    import grpc

    from access_control_srv_tpu_torch.srv import transport_grpc as tg
    from access_control_srv_tpu_torch.srv.gen import access_control_pb2 as pb
    from access_control_srv_tpu_torch.srv.gen.rc import (
        access_control_pb2 as rc_ac,
    )

    log(f"  grpc: present {grpc.__version__} (a GrpcServer on "
        f"127.0.0.1:0, the client over loopback)")
    out: dict = {"launches": {}}
    t0 = time.perf_counter()
    rows, calls = SERVE_ROWS, WIRE_BATCHES
    worker = serving_worker(device)
    server = tg.GrpcServer(worker, "127.0.0.1:0").start()
    client = tg.GrpcClient(server.addr)
    ev, engine, tel = worker.evaluator, worker.engine, worker.telemetry
    log(f"  worker on {ev.device}: {ev._compiled.n_rules} rules, native "
        f"encoder {ev.native_active}, started and compiled in "
        f"{time.perf_counter() - t0:.1f} s")

    def rpc(method: str, payload: bytes, prefix: str = AC_RPC) -> bytes:
        return client.channel.unary_unary(prefix + method)(payload,
                                                           timeout=600)

    try:
        if not ev.native_active:
            raise AssertionError("phase 22: the native encoder is not active")
        reqs = stress_traffic(rows, seed=11)
        msgs = [wire_bytes(r) for r in reqs]
        payload = batch_envelope(msgs)

        # IsAllowedBatch: the first batch, every kernel call held
        tel.paths.clear()
        raw, launches, _ = checked_call(
            "grpc IsAllowedBatch", lambda: rpc("IsAllowedBatch", payload),
            ("sig_planes", "sig_decide"), stats)
        _add_launches(out["launches"])
        first_paths = tel.paths.snapshot()
        got = pb.BatchResponse.FromString(raw).responses
        if len(got) != rows:
            raise AssertionError(f"phase 22: {len(got)} responses for "
                                 f"{rows} rows")
        if first_paths.get("native-wire", 0) != rows:
            raise AssertionError(f"phase 22: native-wire counted "
                                 f"{first_paths} for {rows} rows")
        ref = ev.is_allowed_batch(clone(reqs))
        for b in range(rows):
            want = _pb_key(tg.response_to_pb(ref[b]))
            if _pb_key(got[b]) != want:
                raise AssertionError(f"phase 22 row {b}: rpc "
                                     f"{_pb_key(got[b])} != is_allowed_batch "
                                     f"{want}")
        for b in sorted(random.Random(3).sample(range(rows), min(32, rows))):
            want = _pb_key(tg.response_to_pb(
                engine.is_allowed(clone(reqs[b]))))
            if _pb_key(got[b]) != want:
                raise AssertionError(f"phase 22 row {b}: rpc "
                                     f"{_pb_key(got[b])} != oracle {want}")
        log(f"  IsAllowedBatch {rows} rows: launches {launches}; every kernel "
            f"call equal to its plain version; every row equal to "
            f"is_allowed_batch (decision, cacheable, status); 32 sampled "
            f"rows equal to the oracle; native-wire counted every row")

        # warm wire-to-wire rate, the stage breakdown, the evaluator's
        # wire call on the same rows in the same worker
        rpc("IsAllowedBatch", payload)
        tel.stages.clear()
        pauses = []

        def on_gc(phase: str, info: dict, start=[0.0]) -> None:
            # the collector runs one collection at a time, whichever
            # thread triggers it: each start pairs with the next stop
            if phase == "start":
                start[0] = time.perf_counter()
            else:
                pauses.append((info["generation"],
                               time.perf_counter() - start[0]))

        gc.callbacks.append(on_gc)
        try:
            t0 = time.perf_counter()
            for _ in range(calls):
                rpc("IsAllowedBatch", payload)
            dt = (time.perf_counter() - t0) / calls
        finally:
            gc.callbacks.remove(on_gc)
        out["stages"] = stage_breakdown(tel)
        out["gc"] = {f"gen{g}": {
            "collections": sum(1 for k, _ in pauses if k == g),
            "total_ms": sum(t for k, t in pauses if k == g) * 1e3,
            "max_ms": max((t for k, t in pauses if k == g), default=0.0)
            * 1e3} for g in range(3)}
        t0 = time.perf_counter()
        for _ in range(calls):
            ev.is_allowed_batch_wire(msgs)
        dt_ev = (time.perf_counter() - t0) / calls
        out.update(rows=rows, calls=calls, batch_ms=dt * 1e3,
                   decisions_per_s=rows / dt,
                   evaluator_wire_decisions_per_s=rows / dt_ev,
                   evaluator_wire_batch_ms=dt_ev * 1e3)
        log(f"  wire-to-wire on {card}: {rows / dt:.0f} decisions/s over "
            f"{calls} IsAllowedBatch calls of {rows} rows ({dt * 1e3:.3f} ms "
            f"a call); phase 19's evaluator wire {wire_rate:.0f} "
            f"decisions/s; this worker's is_allowed_batch_wire "
            f"{rows / dt_ev:.0f} decisions/s ({dt_ev * 1e3:.3f} ms) on the "
            f"same rows")
        log(f"  stage breakdown on {card}: {json.dumps(out['stages'])}")
        log(f"  the collector in this process during those {calls} calls "
            f"(gc.callbacks): {json.dumps(out['gc'])}")

        # unary IsAllowed at the deployed window: concurrent callers
        # through the micro-batcher
        ureqs = stress_traffic(GRPC_UNARY_CALLS, seed=19)
        umsgs = [wire_bytes(r) for r in ureqs]
        deployed = unary_cell(worker, server.addr, umsgs, card,
                              "cfg/config.json")
        answers = deployed.pop("answers")
        _add_launches(out["launches"])
        walk_s = 0.0
        for i, resp in enumerate(answers):
            req = clone(ureqs[i])
            t0 = time.perf_counter()
            want = ev._oracle_is_allowed(req)
            walk_s += time.perf_counter() - t0
            if resp != tg.response_to_pb(want).SerializeToString():
                raise AssertionError(f"phase 22 unary {i}: != the oracle")
        for i in random.Random(4).sample(range(GRPC_UNARY_CALLS), 32):
            want = tg.response_to_pb(engine.is_allowed(
                clone(ureqs[i]))).SerializeToString()
            if answers[i] != want:
                raise AssertionError(f"phase 22 unary {i}: != the "
                                     "unfiltered oracle")
        deployed["oracle_rows_per_s"] = GRPC_UNARY_CALLS / walk_s
        log(f"  unary IsAllowed: every answer equal to the "
            f"candidate-filtered oracle, 32 to the unfiltered oracle; that "
            f"oracle walks {deployed['oracle_rows_per_s']:.0f} rows/s on "
            f"one thread of this process")

        # the same calls against a worker started with the shipped
        # ``unary`` overlay: its window collects kernel-sized batches
        uworker = serving_worker(device, env=GRPC_UNARY_ENV)
        userver = tg.GrpcServer(uworker, "127.0.0.1:0").start()
        try:
            overlay = unary_cell(
                uworker, userver.addr, umsgs, card,
                f"cfg/config_{GRPC_UNARY_ENV}.json")
            overlay["errors"] = error_counts(uworker.telemetry.paths.snapshot())
        finally:
            userver.stop(0)
            uworker.stop()
        _add_launches(out["launches"])
        if overlay.pop("answers") != answers:
            raise AssertionError("phase 22: the unary overlay's answers "
                                 "differ from the deployed window's")
        if overlay["launches"]["sig_decide"] < 1:
            raise AssertionError("phase 22: no unary batch reached "
                                 "sig_decide through the batcher")
        if overlay["errors"]:
            raise AssertionError(f"phase 22: unary overlay error counts "
                                 f"{overlay['errors']}")
        out["unary"] = {"deployed": deployed, GRPC_UNARY_ENV: overlay}
        log(f"  unary IsAllowed: the overlay's answers equal the deployed "
            f"window's; sig_decide launched "
            f"{overlay['launches']['sig_decide']} times from its batcher")

        # IsAllowedStream through DevicePipeline, and the same frames from
        # concurrent IsAllowedBatch callers
        step = rows // GRPC_STREAM_FRAMES
        frames = [batch_envelope(msgs[i * step:(i + 1) * step])
                  for i in range(GRPC_STREAM_FRAMES)]
        single = [rpc("IsAllowedBatch", f) for f in frames]
        streamed = list(client.channel.stream_stream(
            AC_RPC + "IsAllowedStream")(iter(frames), timeout=600))
        if streamed != single:
            raise AssertionError("phase 22: a stream frame differs from the "
                                 "batch call on the same rows")
        import threading
        from concurrent.futures import ThreadPoolExecutor

        barrier = threading.Barrier(GRPC_CONCURRENT)

        def racer(k: int) -> list:
            barrier.wait(timeout=60)
            return [rpc("IsAllowedBatch", frames[k % len(frames)])
                    for _ in range(2)]

        with ThreadPoolExecutor(GRPC_CONCURRENT) as pool:
            raced = list(pool.map(racer, range(GRPC_CONCURRENT)))
        for k, answers in enumerate(raced):
            if any(a != single[k % len(frames)] for a in answers):
                raise AssertionError(f"phase 22: concurrent caller {k} got "
                                     "other bytes than a single caller")
        log(f"  IsAllowedStream: {len(frames)} frames of {step} rows, each "
            f"equal to the batch call; {GRPC_CONCURRENT} concurrent "
            f"IsAllowedBatch callers x 2 calls got the single-caller bytes")

        # hot policy updates over gRPC (the delta patcher), then the
        # patched tables under full checks
        out["crud"] = grpc_crud_segment(rpc, pb, worker, tg, card)
        out["patched"] = grpc_patched_checks(rpc, pb, worker, tg, reqs,
                                             payload, stats, card)
        for k, v in out["patched"]["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v

        # the rest of the surface
        health = pb.HealthCheckResponse.FromString(
            rpc("Check", pb.HealthCheckRequest().SerializeToString(),
                prefix="/acstpu.Health/"))
        cmd = client.command("health_check")
        if health.status != "SERVING" or cmd.get("status") != "SERVING":
            raise AssertionError(f"phase 22: health {health.status}, "
                                 f"health_check {cmd.get('status')}")
        rc_raw = rpc("IsAllowed", umsgs[0], prefix=RC_AC_RPC)
        rc_resp = rc_ac.Response.FromString(rc_raw)
        ac_resp = pb.Response.FromString(rpc("IsAllowed", umsgs[0]))
        rc_key = (rc_ac.Response.Decision.Name(rc_resp.decision),
                  rc_resp.evaluation_cacheable,
                  rc_resp.operation_status.code,
                  rc_resp.operation_status.message)
        ac_key = (pb.Decision.Name(ac_resp.decision),
                  ac_resp.evaluation_cacheable,
                  ac_resp.operation_status.code,
                  ac_resp.operation_status.message)
        if rc_key != ac_key:
            raise AssertionError(f"phase 22: restorecommerce IsAllowed "
                                 f"{rc_key} != acstpu {ac_key}")
        log(f"  Health {health.status}; Command health_check "
            f"{cmd['status']} (policy_update {json.dumps(cmd.get('policy_update'))}); "
            f"restorecommerce IsAllowed {rc_key} equal to the acstpu answer")

        paths = tel.paths.snapshot()
        bad = error_counts(paths)
        if bad:
            raise AssertionError(f"phase 22: error counts {bad}")
        out["paths"] = paths
        log(f"  paths since the first batch: {json.dumps(paths)}; every "
            f"error, hang-fallback and degraded count 0")
    finally:
        client.close()
        server.stop(0)
        worker.stop()
    return out


def phase_hot_updates(device, stats: dict, card: str) -> dict:
    """Phase 23: K1 on patched tables at scoped_511 (phase 5's tree and
    rows) through a ``PolicyStore`` on that engine: one in-capacity rule
    edit (a patch), then one batch with the counts set to 0 just before
    and read just after, every ``decide_dense`` call held against its
    plain version and 32 rows against the oracle (no library built or
    loaded since the warm batch before the edit); one rule create that
    takes the tree to 512 rules, which must take the
    ``prefilter-threshold-crossed`` fallback.  Between the two, the cost
    of padding: K1 on the same rows over unpadded tables (a
    ``delta_enabled=False`` evaluator) beside the bucketed ones."""
    from access_control_srv_tpu_torch.srv.store import PolicyStore

    engine = AccessController()
    ev = HybridEvaluator(engine, device=device)
    store = PolicyStore(engine, evaluator=ev)
    store.seed(*store_docs(stress_doc(511, scoped=True)))
    rng = random.Random(5)
    reqs = grid_requests(rng, 4096 - 5, stress=True) + odd_requests(rng, True)
    out: dict = {"caps": ev.delta_stats()["capacities"]}

    # the serving kernel warm before the mutation: its library loaded
    ev.is_allowed_batch(clone(reqs))
    rules = store.get_resource_service("rule")
    doc = store.collections["rule"].get("r1")
    doc["effect"] = "DENY" if doc["effect"] == "PERMIT" else "PERMIT"
    before, built = ev.delta_stats(), built_state()
    t0 = time.perf_counter()
    rules.update([doc])
    out["patch_ms"] = (time.perf_counter() - t0) * 1e3
    moved = delta_moved(before, ev.delta_stats())
    if moved != {"patches": 1, "recompiles_avoided": 1}:
        raise AssertionError(f"phase 23: the rule edit moved {moved}")
    responses, launches, chk = checked_call(
        "K1 on patched tables", lambda: ev.is_allowed_batch(
            clone(reqs)), ("decide_dense",), stats, dense=True)
    n = sample_oracle(engine, reqs, responses)
    if built != built_state():
        raise AssertionError("phase 23: the patch built or loaded a library")
    out["launches"] = launches
    k1_on = max(chk.calls["decide_dense"],
                key=lambda a: a[1]["r_n_ra"].shape[0])
    log(f"  scoped_511 through a PolicyStore (capacities {out['caps']}): "
        f"rule r1's effect flipped, one patch in {out['patch_ms']:.1f} ms; "
        f"{len(reqs)} rows on the patched tables: launches {launches}, "
        f"every decide_dense call equal to its plain version, {n} rows "
        f"equal to the oracle; no library built or loaded")

    flat = HybridEvaluator(engine, device=device, delta_enabled=False)
    with captured("decide_dense", kmod) as calls:
        flat.is_allowed_batch(clone(reqs))
    k1_off = max(calls, key=lambda a: a[1]["r_n_ra"].shape[0])
    del flat
    out["padding_k1"] = padding_cost("decide_dense", k1_off, k1_on, card,
                                     "scoped_511")

    rules.create([{**{k: v for k, v in doc.items() if k != "meta"},
                   "id": "r511"}])
    policy = store.collections["policy"].get("p0")
    policy["rules"] = policy["rules"] + ["r511"]
    before = ev.delta_stats()
    store.get_resource_service("policy").update([policy])
    moved = delta_moved(before, ev.delta_stats())
    want = {"fallbacks": 1, "full_compiles": 1,
            "reasons": {"prefilter-threshold-crossed": 1}}
    if moved != want or ev._compiled.n_rules != 512 \
            or not ev._kernel.active:
        raise AssertionError(f"phase 23: the 512th rule moved {moved}")
    log(f"  the 512th rule attached: delta_stats moved {json.dumps(moved)} "
        f"(a full bucketed recompile onto the signature path)")
    return out


CRUD_RULE = "r1"        # a stress rule of policy p0 (stress_doc)
CRUD_POLICY = "p0"
CRUD_NEW_RULE = "r_probe"
FA = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable"


def grpc_crud_segment(rpc, pb, worker, tg, card: str) -> dict:
    """Phase 22's CRUD segment: ``RuleService`` / ``PolicyService`` RPCs
    on the serve-20k Worker, in this order:

    - policy ``p0``'s combining algorithm changed, then restored: two
      ``combining-algorithm-changed`` fallbacks, each a full bucketed
      recompile on the Worker's debounced compile thread;
    - rule ``r1`` moved onto a fresh role, then back: two in-capacity
      patches (a probe of that role goes INDETERMINATE -> PERMIT -> back);
    - a rule created (unreferenced: a noop) and attached to ``p0`` (a
      patch; a probe of its role turns PERMIT);
    - ``r1`` sent again unchanged: a noop.

    After each: ``delta_stats()`` moved exactly as expected (the reason
    named), the probe (``GRPC_FLIP_ROWS`` copies through the native wire
    path) equals the oracle, the ``Update`` RPC's own time, the time to
    visibility, and on a patch its split (``apply_events``, the kernel's
    construction and upload, the native encoder, the candidate index, the
    first batch, K2 included).  No library is built or loaded across the
    in-capacity patches."""
    ev, engine = worker.evaluator, worker.engine
    rs, ps = "/acstpu.RuleService/", "/acstpu.PolicyService/"
    original = pb.RuleListResponse.FromString(
        rpc("Read", pb.ReadRequest(ids=[CRUD_RULE]).SerializeToString(),
            prefix=rs)).items[0]
    policy = pb.PolicyListResponse.FromString(
        rpc("Read", pb.ReadRequest(ids=[CRUD_POLICY]).SerializeToString(),
            prefix=ps)).items[0]
    flipped = pb.Rule()
    flipped.CopyFrom(original)
    flipped.target.subjects[0].value = "probe-role"
    created = pb.Rule()
    created.CopyFrom(original)
    created.id = CRUD_NEW_RULE
    created.effect = "PERMIT"
    created.target.subjects[0].value = "probe-role-2"
    created.ClearField("meta")
    attached = pb.Policy()
    attached.CopyFrom(policy)
    attached.rules.append(CRUD_NEW_RULE)
    other_ca = pb.Policy()
    other_ca.CopyFrom(policy)
    other_ca.combining_algorithm = FA

    def probe_for(role: str):
        req = clone(stress_traffic(1, seed=31)[0])
        req.target.subjects[0].value = role
        req.context["subject"]["role_associations"][0]["role"] = role
        req.target.resources[0].value = original.target.resources[0].value
        req.target.actions[0].value = original.target.actions[0].value
        return req, batch_envelope([wire_bytes(req)] * GRPC_FLIP_ROWS)

    probes = {role: probe_for(role) for role in ("probe-role",
                                                 "probe-role-2")}
    fallback = {"fallbacks": 1, "full_compiles": 1,
                "reasons": {"combining-algorithm-changed": 1}}
    patch = {"patches": 1, "recompiles_avoided": 1}
    steps = [
        ("ca-change", ps + "Update", pb.PolicyList(items=[other_ca]),
         fallback, "probe-role", pb.INDETERMINATE),
        ("ca-restore", ps + "Update", pb.PolicyList(items=[policy]),
         fallback, "probe-role", pb.INDETERMINATE),
        ("flip", rs + "Update", pb.RuleList(items=[flipped]), patch,
         "probe-role", pb.PERMIT),
        ("flip-back", rs + "Update", pb.RuleList(items=[original]), patch,
         "probe-role", pb.INDETERMINATE),
        ("create", rs + "Create", pb.RuleList(items=[created]),
         {"noops": 1}, "probe-role-2", pb.INDETERMINATE),
        ("attach", ps + "Update", pb.PolicyList(items=[attached]), patch,
         "probe-role-2", pb.PERMIT),
        ("noop", rs + "Update", pb.RuleList(items=[original]),
         {"noops": 1}, "probe-role", pb.INDETERMINATE),
    ]
    out: dict = {"steps": {}}
    built = None
    for label, path, msg, expect, role, want in steps:
        probe, probe_batch = probes[role]
        if label == "flip":
            built = built_state()
        before = ev.delta_stats()
        t0 = time.perf_counter()
        status = pb.MutationResponse.FromString(
            rpc(path.rsplit("/", 1)[1], msg.SerializeToString(),
                prefix=path.rsplit("/", 1)[0] + "/")).operation_status
        t1 = time.perf_counter()
        if status.code != 200:
            raise AssertionError(f"phase 22 {label}: {status}")
        if "fallbacks" in expect:
            # the full recompile runs on the compile thread: visible once
            # it has published the latest version
            await_compile(ev)
        t2 = time.perf_counter()
        split = dict(ev.last_patch_split or {}) if "patches" in expect \
            else {}
        reset_launches()
        tb = time.perf_counter()
        got = pb.BatchResponse.FromString(
            rpc("IsAllowedBatch", probe_batch)).responses
        first_ms = (time.perf_counter() - tb) * 1e3
        first_launches = dict(kmod.LAUNCHES)
        t3 = time.perf_counter()
        moved = delta_moved(before, ev.delta_stats())
        if moved != expect:
            raise AssertionError(f"phase 22 {label}: delta_stats moved "
                                 f"{moved}, expected {expect}")
        oracle = tg.response_to_pb(engine.is_allowed(clone(probe)))
        if any(_pb_key(r) != _pb_key(oracle) for r in got) \
                or got[0].decision != want:
            raise AssertionError(f"phase 22 {label}: probe "
                                 f"{_pb_key(got[0])}, oracle "
                                 f"{_pb_key(oracle)}, expected "
                                 f"{pb.Decision.Name(want)}")
        if "patches" in expect and first_launches["sig_planes"] < 1:
            raise AssertionError(f"phase 22 {label}: the first batch after "
                                 "the patch launched no sig_planes")
        step = {"moved": moved, "update_ms": (t1 - t0) * 1e3,
                "visibility_ms": (t3 - t0) * 1e3,
                "first_batch_ms": first_ms,
                "first_batch_launches": {k: v for k, v in
                                         first_launches.items() if v},
                "decision": pb.Decision.Name(got[0].decision)}
        if "fallbacks" in expect:
            step["recompile_ms"] = (t2 - t0) * 1e3
        if split:
            step["split_ms"] = {**split, "first_batch_ms": first_ms}
        out["steps"][label] = step
        log(f"  CRUD {label} on {card}: {path.rsplit('/', 2)[1]}/"
            f"{path.rsplit('/', 1)[1]} {step['update_ms']:.1f} ms; "
            f"delta_stats moved {json.dumps(moved)}; time to visibility "
            f"{step['visibility_ms']:.1f} ms"
            + (f" (split ms: {json.dumps(step['split_ms'])})" if split
               else "")
            + (f" (the recompile published after "
               f"{step['recompile_ms']:.1f} ms)" if "recompile_ms" in step
               else "")
            + f"; the probe {step['decision']} equal to the oracle; first "
            f"batch launches {step['first_batch_launches']}")
    if built != built_state():
        raise AssertionError("phase 22: an in-capacity patch built or "
                             "loaded a library")
    out["stats"] = ev.delta_stats()
    log(f"  delta_stats after the segment: {json.dumps(out['stats'])}; no "
        "library built or loaded across the patches")
    return out


def grpc_patched_checks(rpc, pb, worker, tg, reqs, payload, stats: dict,
                        card: str) -> dict:
    """The serve-20k Worker's patched tables (after the CRUD segment)
    under full checks: one ``SERVE_ROWS``-row ``IsAllowedBatch`` with
    every kernel call held against its plain version and 32 rows against
    the oracle; a batch with 16 ACL rows (K4) the same way, its ACL rows
    among the sampled; ``WhatIsAllowedBatch`` of ``GRPC_WIA_QUERIES``
    queries (and ``GRPC_WIA_UNARY`` unary calls) with every
    ``wia_planes`` call held against its plain version and every answer
    equal to ``engine.what_is_allowed``; the tables canonically equal to
    a fresh ``full_bucketed_compile`` of the final tree.  Then the cost
    of padding: K3 on the same rows over unpadded tables (a
    ``delta_enabled=False`` evaluator) beside the bucketed ones."""
    from access_control_srv_tpu_torch.ops import delta as dmod

    ev, engine = worker.evaluator, worker.engine
    out: dict = {"launches": {}}
    if ev.delta_stats()["patches"] < 1 or ev._compiled.version != ev._version:
        raise AssertionError("phase 22: the tables are not the patched ones")

    def wire_checked(label, pay, rows, expect, always=()):
        raw, launches, chk = checked_call(label, lambda: rpc(
            "IsAllowedBatch", pay), expect, stats)
        _add_launches(out["launches"])
        got = pb.BatchResponse.FromString(raw).responses
        idx = sorted(set(random.Random(5).sample(range(len(rows)), 32))
                     | set(always))
        for i, want in zip(idx, oracle_walks(engine, rows, idx)):
            if _pb_key(got[i]) != _pb_key(tg.response_to_pb(want)):
                raise AssertionError(f"phase 22 {label} row {i}: "
                                     f"{_pb_key(got[i])} != the oracle")
        log(f"  {label} on the patched tables: {len(rows)} rows, launches "
            f"{launches}; every kernel call equal to its plain version; "
            f"{len(idx)} rows equal to the oracle")
        return launches, chk

    launches, chk = wire_checked("IsAllowedBatch", payload, reqs,
                                 ("sig_planes", "sig_decide"))
    out["batch"] = launches
    k3_on = chk.args["sig_decide"]
    acl = stress_traffic(1024, seed=37, n_acl=16)
    acl_rows = [i for i, r in enumerate(acl)
                if any((res.get("meta") or {}).get("acls")
                       for res in r.context.get("resources") or [])]
    out["acl"], _ = wire_checked(
        "IsAllowedBatch with 16 ACL rows",
        batch_envelope([wire_bytes(r) for r in acl]), acl,
        ("decide_grouped",), always=acl_rows)

    wreqs = stress_traffic(GRPC_WIA_QUERIES, seed=29)
    wmsgs = [wire_bytes(r) for r in wreqs]
    wia_stats: dict = {}
    reset_launches()
    with WiaCheck(wia_stats):
        wraw = rpc("WhatIsAllowedBatch", batch_envelope(wmsgs))
        wunary = [rpc("WhatIsAllowed", m) for m in wmsgs[:GRPC_WIA_UNARY]]
    wlaunch = dict(kmod.LAUNCHES)
    _add_launches(out["launches"])
    st = stats.setdefault("wia_planes", {"calls": 0, "max_abs_err": 0})
    st["max_abs_err"] = max(st["max_abs_err"], wia_stats.get(
        "wia_planes", {}).get("max_abs_err", 0))
    if wlaunch["wia_planes"] < 1:
        raise AssertionError("phase 22: whatIsAllowed launched no "
                             "wia_planes")
    wgot = pb.BatchReverseQuery.FromString(wraw).responses
    for i, r in enumerate(wreqs):
        want = tg.reverse_query_to_pb(
            engine.what_is_allowed(clone(r))).SerializeToString()
        if wgot[i].SerializeToString() != want or (
                i < len(wunary) and wunary[i] != want):
            raise AssertionError(f"phase 22 whatIsAllowed {i}: != "
                                 "engine.what_is_allowed")
    out["wia"] = wlaunch
    log(f"  WhatIsAllowedBatch {GRPC_WIA_QUERIES} queries and "
        f"{len(wunary)} WhatIsAllowed on the patched tables: launches "
        f"{wlaunch}; every wia_planes call equal to its plain version; "
        f"every answer equal to engine.what_is_allowed")

    t0 = time.perf_counter()
    fresh = dmod.full_bucketed_compile(engine.policy_sets, engine.urns)[0]
    if dmod.canonical_tables(ev._compiled) != dmod.canonical_tables(fresh):
        raise AssertionError("phase 22: the patched tables differ from a "
                             "fresh full_bucketed_compile of the tree")
    log(f"  the patched tables canonically equal to a fresh "
        f"full_bucketed_compile of the final tree (checked in "
        f"{time.perf_counter() - t0:.1f} s)")

    # the cost of padding: K3 on the same rows, unpadded tables
    flat = HybridEvaluator(engine, device=ev.device, delta_enabled=False)
    with captured("sig_decide", pfmod) as calls:
        flat.is_allowed_batch_wire([wire_bytes(r) for r in reqs])
    out["padding_k3"] = padding_cost("sig_decide", calls[-1], k3_on, card,
                                     "serve-20k")
    del flat
    return out


class captured:
    """While active, every call of wrapper ``name`` in ``mod`` is
    recorded (its arguments, untouched) and launched as it is."""

    def __init__(self, name: str, mod):
        self.name, self.mod = name, mod
        self.calls: list[tuple] = []

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def rec(*args, **kw):
            self.calls.append(args)
            return self.orig(*args, **kw)

        setattr(self.mod, self.name, rec)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)
        return False


def padding_cost(name: str, unpadded: tuple, bucketed: tuple, card: str,
                 cell: str) -> dict:
    """K1 or K3 on the same rows over unpadded (``delta_enabled=False``)
    and capacity-bucketed tables: through the wrapper (CUDA events, the
    mean of ITERS launches after a warm-up) and packed once
    (``time_steady``, the two taking turns), with each call's table
    shapes."""
    wrapper = {"decide_dense": kmod.decide_dense,
               "sig_decide": kmod.sig_decide}[name]
    through = [time_ms(lambda a=a: wrapper(*a)) for a in (unpadded,
                                                          bucketed)]
    packed = time_steady(*(prepacked(kmod, name, a) for a in (unpadded,
                                                              bucketed)))
    table = "rule_valid"
    shapes = [list((a[0] if name == "decide_dense" else a[1])[table].shape)
              for a in (unpadded, bucketed)]
    out = {"unpadded_ms": through[0], "bucketed_ms": through[1],
           "unpadded_packed_ms": packed[0], "bucketed_packed_ms": packed[1],
           "rule_valid_shapes": shapes}
    log(f"  padding cost, {name} at {cell} on {card}: through the wrapper "
        f"{through[0]:.4f} ms unpadded, {through[1]:.4f} ms bucketed; packed "
        f"once {packed[0]:.4f} / {packed[1]:.4f} ms; {table} shapes "
        f"{shapes[0]} / {shapes[1]}")
    return out


# ------------------------------------------- phase 24: the cluster tier


CLUSTER_REPLICAS = 2
CLUSTER_CALLS = 8            # warm routed IsAllowedBatch calls
CLUSTER_PROBE_ROWS = 64      # the CRUD probe batch, sent to each replica
CLUSTER_TIMEOUT_S = 300.0    # a replica's boot, a convergence, a sweep
# the audit sweep's lattice: 32 stress subjects x 32 stress resources x 1
CLUSTER_LATTICE = {"subjects": 32, "resources": 32, "actions": ["read"]}
CLUSTER_KERNELS = ("sig_planes", "sig_decide", "decide_grouped",
                   "wia_planes")


def cluster_seed(n_rules: int) -> dict:
    """``serve-20k`` as the policy store keeps it, in the order its
    journal takes it: the seed data's documents, then
    ``stress_doc(n_rules)``'s (what phase 22's worker holds)."""
    from access_control_srv_tpu_torch.srv.worker import _yaml_list

    seed = os.path.join(REPO, "data", "seed_data")
    sets, policies, rules = store_docs(stress_doc(n_rules))
    return {
        "rules": _yaml_list(os.path.join(seed, "rules.yaml")) + rules,
        "policies": _yaml_list(os.path.join(seed, "policies.yaml"))
        + policies,
        "policy_sets": _yaml_list(os.path.join(seed, "policy_sets.yaml"))
        + sets,
    }


def build_dir_state() -> dict:
    """Every file under ``_build/`` with its size and modification time."""
    d = cuda_build.BUILD_DIR
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(d.iterdir())} if d.is_dir() else {}


class Replicas:
    """Channels to a cluster's replicas and its router: raw unary calls
    and Commands."""

    def __init__(self, cluster):
        import grpc

        from access_control_srv_tpu_torch.srv.gen import (
            access_control_pb2 as pb,
        )
        from access_control_srv_tpu_torch.srv.transport_grpc import (
            _MESSAGE_SIZE_OPTIONS,
        )

        self.grpc, self.pb, self.opts = grpc, pb, _MESSAGE_SIZE_OPTIONS
        self.cluster = cluster
        self.channels: dict = {}

    def channel(self, addr: str):
        if addr not in self.channels:
            self.channels[addr] = self.grpc.insecure_channel(
                addr, options=self.opts)
        return self.channels[addr]

    @property
    def addrs(self) -> list:
        return [r.addr for r in self.cluster.replicas]

    @property
    def router(self) -> str:
        return self.cluster.router.addr

    def call(self, addr: str, method: str, payload: bytes,
             prefix: str = AC_RPC) -> bytes:
        return self.channel(addr).unary_unary(prefix + method)(
            payload, timeout=CLUSTER_TIMEOUT_S)

    def command(self, addr: str, name: str, payload=None) -> dict:
        pb = self.pb
        req = pb.CommandRequest(name=name)
        if payload is not None:
            req.payload = json.dumps(payload).encode()
        raw = self.call(addr, "Command", req.SerializeToString(),
                        prefix="/acstpu.CommandInterface/")
        return json.loads(pb.CommandResponse.FromString(raw).payload
                          or b"{}")

    def each(self, name: str, payload=None) -> dict:
        return {a: self.command(a, name, payload) for a in self.addrs}

    def calls_by_replica(self) -> dict:
        return {r["addr"]: r["calls"]
                for r in self.cluster.router.status()["replicas"]}

    def close(self) -> None:
        for ch in self.channels.values():
            ch.close()
        self.channels = {}


def wait_routable(rep: Replicas) -> float:
    """Wait until the router holds every replica healthy, not draining
    and with its breaker closed; returns the seconds waited.  Its health
    probe times out after 0.5 s, which a replica busy with a full
    recompile can miss, and a call routed before the next probe lands
    would find no replica eligible."""
    t0 = time.perf_counter()
    while not all(r["healthy"] and not r["draining"]
                  and r["breaker"] == "closed"
                  for r in rep.cluster.router.status()["replicas"]):
        if time.perf_counter() - t0 > CLUSTER_TIMEOUT_S:
            raise AssertionError(f"phase 24: the router never held every "
                                 f"replica eligible: "
                                 f"{rep.cluster.router.status()}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def cluster_convergence(rep: Replicas, label: str, path: str, msg,
                        probe_batch: bytes, want: int, expect: dict,
                        card: str) -> dict:
    """One CRUD RPC through the router, then the time until every
    replica reports one new ``table_fingerprint`` at one policy epoch
    and the probe batch sent directly to each replica answers ``want``
    on every row; ``delta_stats`` must have moved by ``expect`` on every
    replica (locally on the one that served the RPC, through its
    ``PolicyReplicator`` on the others)."""
    pb = rep.pb
    before_ids = rep.each("program_identity")
    before_pu = {a: h["policy_update"]
                 for a, h in rep.each("health_check").items()}
    old_fp = {i["table_fingerprint"] for i in before_ids.values()}
    routable_s = wait_routable(rep)
    calls = rep.calls_by_replica()
    t0 = time.perf_counter()
    method = path.rsplit("/", 1)[1]
    status = pb.MutationResponse.FromString(rep.call(
        rep.router, method, msg.SerializeToString(),
        prefix=path.rsplit("/", 1)[0] + "/")).operation_status
    rpc_ms = (time.perf_counter() - t0) * 1e3
    if status.code != 200:
        raise AssertionError(f"phase 24 {label}: {status}")
    deadline = t0 + CLUSTER_TIMEOUT_S
    polls = 0
    while True:
        polls += 1
        ids = rep.each("program_identity")
        fps = {i["table_fingerprint"] for i in ids.values()}
        epochs = {i["policy_epoch"] for i in ids.values()}
        if len(fps) == 1 and not fps & old_fp and len(epochs) == 1:
            answers = {a: pb.BatchResponse.FromString(rep.call(
                a, "IsAllowedBatch", probe_batch)).responses
                for a in rep.addrs}
            if all(r.decision == want for got in answers.values()
                   for r in got):
                break
        if time.perf_counter() > deadline:
            raise AssertionError(f"phase 24 {label}: no convergence in "
                                 f"{CLUSTER_TIMEOUT_S} s: {ids}")
        time.sleep(0.005)
    conv_ms = (time.perf_counter() - t0) * 1e3
    after_pu = {a: h["policy_update"]
                for a, h in rep.each("health_check").items()}
    moved = {a: delta_moved(before_pu[a], after_pu[a]) for a in rep.addrs}
    served = [a for a, n in rep.calls_by_replica().items()
              if n != calls.get(a)]
    if any(m != expect for m in moved.values()) or len(served) != 1:
        raise AssertionError(f"phase 24 {label}: delta_stats moved {moved} "
                             f"(expected {expect} on every replica), RPC "
                             f"served by {served}")
    out = {"rpc_ms": rpc_ms, "convergence_ms": conv_ms, "polls": polls,
           "routable_wait_s": routable_s,
           "served_by": served[0], "moved": moved[served[0]],
           "epoch": epochs.pop(), "fingerprint": fps.pop()}
    log(f"  CRUD {label} through the router on {card} (sent once the "
        f"router held every replica eligible, {routable_s:.2f} s after the "
        f"last step): the RPC "
        f"{rpc_ms:.1f} ms, served by {served[0]}; every replica on one new "
        f"table_fingerprint at epoch {out['epoch']} and the probe "
        f"({CLUSTER_PROBE_ROWS} rows sent to each replica) "
        f"{pb.Decision.Name(want)} after {conv_ms:.1f} ms (time to "
        f"convergence); delta_stats moved {json.dumps(out['moved'])} on the "
        f"replica that served it, the same through the PolicyReplicator on "
        f"the other")
    return out


def cluster_window(rep: Replicas, paths0: dict, device, label: str) -> dict:
    """The kernel launches of every replica since its counts were set to
    0, and the rows each served by path since ``paths0`` (the Command
    ``metrics``): every batch on the kernel path, none on the oracle, no
    error count; on the card every replica launched a kernel."""
    launches = rep.each("kernel_launches")
    moved = {}
    for a, m in rep.each("metrics").items():
        before = paths0.get(a, {})
        moved[a] = {k: v - before.get(k, 0) for k, v in m["paths"].items()
                    if v != before.get(k, 0)}
    for a, m in moved.items():
        served = m.get("native-wire", 0) + m.get("kernel", 0) + m.get(
            "kernel-wia", 0)
        if m.get("oracle", 0) or m.get("oracle-wia", 0) or error_counts(m):
            raise AssertionError(f"phase 24 ({label}): replica {a}'s paths "
                                 f"{m}: not the kernel path")
        if served and device.type == "cuda" and not any(
                launches[a]["launches"].values()):
            raise AssertionError(f"phase 24 ({label}): replica {a} served "
                                 f"{served} rows and launched no kernel")
    return {"paths": moved,
            "launches_by_replica": {a: {k: v for k, v in
                                        m["launches"].items() if v}
                                    for a, m in launches.items()},
            "launches": {k: sum(m["launches"][k] for m in launches.values())
                         for k in kmod.LAUNCHES}}


def cluster_tier(device, n_rules: int = SERVE_RULES) -> dict:
    """Phase 24's ``LocalCluster`` with its broker started and its journal
    seeded (no replica yet): host work the full run does while phase 2's
    nvcc processes build.  The broker is stopped at exit if phase 24
    never runs."""
    from access_control_srv_tpu_torch.parallel.cluster import LocalCluster

    work = tempfile.mkdtemp(prefix="acs-cluster-")
    m0 = time.monotonic()
    docs = cluster_seed(n_rules)
    docs_s = time.monotonic() - m0
    cluster = LocalCluster(
        n_replicas=CLUSTER_REPLICAS, seed_cfg=docs,
        base_dir=os.path.join(work, "tier"),
        cfg_extra={
            "replication": {"catchup_timeout_s": CLUSTER_TIMEOUT_S},
            "audit": {"enabled": True, "chunk_size": 256,
                      "out_dir": os.path.join(work, "audit")}},
        router_cfg={"health_interval_s": 0.5, "max_retries": 1},
        replica_timeout_s=CLUSTER_TIMEOUT_S, device=str(device))
    atexit.register(shutil.rmtree, work, True)
    atexit.register(cluster.stop)
    cluster.start_broker()
    return {"cluster": cluster, "work": work,
            "frames": sum(len(v) for v in docs.values()),
            "seeding_s": {"documents": docs_s,
                          "broker": cluster.broker_ready_at - m0,
                          "seeded": cluster.seeded_at - m0}}


def phase_cluster(device, stats: dict, card: str, serve_pre,
                  direct_rate: float, tier: dict | None = None,
                  n_rules: int = SERVE_RULES,
                  rows: int = SERVE_ROWS) -> dict:
    """Phase 24: the cluster tier (the module docstring's item 24).
    ``LocalCluster`` runs a port broker, ``CLUSTER_REPLICAS`` port replica
    processes on ``device`` and a port router in this process; the
    journal is seeded once with ``n_rules`` stress rules and the seed data
    and the replicas boot by replaying it in parallel, loading the
    libraries phase 2 built.  ``serve_pre`` is phase 19's (engine,
    evaluator, seconds) on the same tree: the oracle of the checks and
    the direct-mode sweep.  ``direct_rate`` is phase 22's wire-to-wire
    decisions/s, printed beside the routed rate.  ``tier`` is
    ``cluster_tier``'s (made here when None)."""
    from concurrent.futures import ThreadPoolExecutor

    from access_control_srv_tpu_torch import native
    from access_control_srv_tpu_torch.ops.lattice import diff_snapshots
    from access_control_srv_tpu_torch.srv import transport_grpc as tg

    engine, evaluator, _ = serve_pre
    t_phase = time.perf_counter()
    out: dict = {}
    # the libraries this phase's replicas load: already built by phases
    # 2 and 19 in the full run (no build here either)
    if device.type == "cuda":
        cuda_build.build(list(SOURCES))
    native.load()
    built = build_dir_state()
    reqs = stress_traffic(rows, seed=11)
    msgs = [wire_bytes(r) for r in reqs]
    payload = batch_envelope(msgs)
    if tier is None:
        tier = cluster_tier(device, n_rules)
    cluster, work, frames = tier["cluster"], tier["work"], tier["frames"]
    out["seeding_s"] = tier["seeding_s"]
    rep = Replicas(cluster)
    try:
        m0 = time.monotonic()
        cluster.start()
        out["timeline_s"] = {
            "spawned": min(r.spawned_at for r in cluster.replicas) - m0,
            "ready": max(r.ready_at for r in cluster.replicas) - m0,
            "router": time.monotonic() - m0}
        pb = rep.pb
        ident = rep.each("program_identity")
        if {i["policy_epoch"] for i in ident.values()} != {frames} or len(
                {i["table_fingerprint"] for i in ident.values()}) != 1:
            raise AssertionError(f"phase 24: the replicas did not replay "
                                 f"the {frames}-frame journal: {ident}")
        rep.each("kernel_launches", {"reset": True})
        paths0 = {a: m["paths"] for a, m in rep.each("metrics").items()}

        def first(replica) -> tuple:
            raw = rep.call(replica.addr, "IsAllowedBatch", payload)
            return raw, time.monotonic()

        with ThreadPoolExecutor(CLUSTER_REPLICAS) as pool:
            firsts = list(pool.map(first, cluster.replicas))
        out["boot"] = [{
            "spawn_to_ready_s": r.ready_at - r.spawned_at,
            "spawn_to_first_answer_s": t - r.spawned_at}
            for r, (_, t) in zip(cluster.replicas, firsts)]
        if build_dir_state() != built:
            raise AssertionError("phase 24: a replica built a library (the "
                                 "files under _build/ changed)")
        log(f"  {CLUSTER_REPLICAS} replicas on {device} (python -m "
            f"access_control_srv_tpu_torch --device {device}), a broker and "
            f"a router: the journal seeded with {frames} CRUD frames "
            f"({n_rules} stress rules and the seed data; set-up "
            + ", ".join(f"{k} {v:.1f}" for k, v in out["seeding_s"].items())
            + " s: documents built, broker answering, journal seeded) and "
            f"both replicas booted by replaying it, in parallel: "
            + ", ".join(f"{k} {v:.1f}" for k, v in out["timeline_s"].items())
            + " s from the phase's start (spawned, ready, router up); per "
            f"replica, spawn to its ready "
            f"line / to its first answer ({rows} rows, K2's first planes) "
            + ", ".join(f"{b['spawn_to_ready_s']:.2f} / "
                        f"{b['spawn_to_first_answer_s']:.2f} s"
                        for b in out["boot"])
            + f"; no file under _build/ changed ({len(built)} files); "
            f"every replica at epoch {frames}, one table_fingerprint")

        # routed traffic
        base = rep.calls_by_replica()
        t0 = time.perf_counter()
        routed = [rep.call(rep.router, "IsAllowedBatch", payload)
                  for _ in range(CLUSTER_CALLS)]
        dt = (time.perf_counter() - t0) / CLUSTER_CALLS
        shares = {a: n - base.get(a, 0)
                  for a, n in rep.calls_by_replica().items()}
        direct = rep.call(rep.addrs[0], "IsAllowedBatch", payload)
        if any(r != direct for r in routed) or any(
                raw != direct for raw, _ in firsts):
            raise AssertionError("phase 24: routed responses differ from "
                                 "replica 0's direct answer")
        if sorted(shares.values())[0] < 1:
            raise AssertionError(f"phase 24: the router sent every call to "
                                 f"one replica: {shares}")
        got = pb.BatchResponse.FromString(direct).responses
        if len(got) != rows:
            raise AssertionError(f"phase 24: {len(got)} responses for "
                                 f"{rows} rows")
        out.update(rows=rows, calls=CLUSTER_CALLS, batch_ms=dt * 1e3,
                   decisions_per_s=rows / dt, shares=shares)
        log(f"  routed IsAllowedBatch on {card}: {rows / dt:.0f} "
            f"decisions/s over {CLUSTER_CALLS} warm calls of {rows} rows "
            f"({dt * 1e3:.3f} ms a call) against phase 22's direct "
            f"{direct_rate:.0f}; calls per replica {json.dumps(shares)}; "
            f"every response byte-equal to replica 0's direct answer")

        acl = stress_traffic(1024, seed=37, n_acl=16)
        acl_rows = [i for i, r in enumerate(acl)
                    if any((res.get("meta") or {}).get("acls")
                           for res in r.context.get("resources") or [])]
        acl_raw = rep.call(rep.router, "IsAllowedBatch",
                           batch_envelope([wire_bytes(r) for r in acl]))
        windows = [cluster_window(rep, paths0, device, "IsAllowedBatch")]
        log(f"  a {len(acl)}-row batch with {len(acl_rows)} ACL rows through "
            f"the router; kernel launches per replica from the first answers "
            f"on (the counts set to 0 before them) "
            f"{json.dumps(windows[0]['launches_by_replica'])}; each "
            f"replica's paths (Command metrics) "
            f"{json.dumps(windows[0]['paths'])}")

        # CRUD convergence: a patch each way, then a fallback each way, so
        # the tree ends as serve-20k, fully compiled
        rs, ps = "/acstpu.RuleService/", "/acstpu.PolicyService/"
        original = pb.RuleListResponse.FromString(rep.call(
            rep.router, "Read", pb.ReadRequest(
                ids=[CRUD_RULE]).SerializeToString(), prefix=rs)).items[0]
        policy = pb.PolicyListResponse.FromString(rep.call(
            rep.router, "Read", pb.ReadRequest(
                ids=[CRUD_POLICY]).SerializeToString(), prefix=ps)).items[0]
        flipped = pb.Rule()
        flipped.CopyFrom(original)
        flipped.target.subjects[0].value = "probe-role"
        other_ca = pb.Policy()
        other_ca.CopyFrom(policy)
        other_ca.combining_algorithm = FA
        probe = clone(stress_traffic(1, seed=31)[0])
        probe.target.subjects[0].value = "probe-role"
        probe.context["subject"]["role_associations"][0]["role"] = \
            "probe-role"
        probe.target.resources[0].value = original.target.resources[0].value
        probe.target.actions[0].value = original.target.actions[0].value
        probe_batch = batch_envelope([wire_bytes(probe)]
                                     * CLUSTER_PROBE_ROWS)
        patch = {"patches": 1, "recompiles_avoided": 1}
        fallback = {"fallbacks": 1, "full_compiles": 1,
                    "reasons": {"combining-algorithm-changed": 1}}
        out["crud"] = {}
        for label, path, msg, want, expect in (
                ("flip", rs + "Update", pb.RuleList(items=[flipped]),
                 pb.PERMIT, patch),
                ("flip-back", rs + "Update", pb.RuleList(items=[original]),
                 pb.INDETERMINATE, patch),
                ("ca-change", ps + "Update", pb.PolicyList(items=[other_ca]),
                 pb.INDETERMINATE, fallback),
                ("ca-restore", ps + "Update", pb.PolicyList(items=[policy]),
                 pb.INDETERMINATE, fallback)):
            out["crud"][label] = cluster_convergence(
                rep, label, path, msg, probe_batch, want, expect, card)

        # restart replica 1
        errors = {a: error_counts(m["paths"])
                  for a, m in rep.each("metrics").items()}
        fp0 = rep.command(rep.addrs[0], "program_identity")
        cluster.replicas[1].stop()
        t0 = time.perf_counter()
        restarted = cluster.restart_replica(1)
        ready_s = time.perf_counter() - t0
        again = rep.call(restarted.addr, "IsAllowedBatch", payload)
        serve_s = time.perf_counter() - t0
        fp1 = rep.command(restarted.addr, "program_identity")
        ref = rep.call(rep.addrs[0], "IsAllowedBatch", payload)
        if (fp1["table_fingerprint"], fp1["policy_epoch"]) != (
                fp0["table_fingerprint"], fp0["policy_epoch"]) \
                or again != ref or ref != direct:
            raise AssertionError(f"phase 24: the restarted replica "
                                 f"{fp1} differs from replica 0 {fp0}")
        if build_dir_state() != built:
            raise AssertionError("phase 24: the restart built a library")
        out["restart"] = {"ready_s": ready_s, "serves_s": serve_s}
        log(f"  replica 1 stopped and restarted (restart_replica): its "
            f"ready line after {ready_s:.2f} s, serving {rows} rows after "
            f"{serve_s:.2f} s; its table_fingerprint and epoch "
            f"{fp1['policy_epoch']} equal to replica 0's, its answers to the "
            f"routed rows byte-equal to replica 0's (and to the first "
            f"ones: the tree is serve-20k again); _build/ unchanged")

        # whatIsAllowed and the audit sweep through the router (K5), then
        # the same sweep direct in this process
        rep.each("kernel_launches", {"reset": True})
        paths0 = {a: m["paths"] for a, m in rep.each("metrics").items()}
        wait_routable(rep)
        wreqs = stress_traffic(GRPC_WIA_QUERIES, seed=29)
        wraw = rep.call(rep.router, "WhatIsAllowedBatch",
                        batch_envelope([wire_bytes(r) for r in wreqs]))
        t0 = time.perf_counter()
        sweep = rep.command(rep.router, "audit_sweep", {
            "action": "start", "lattice": CLUSTER_LATTICE, "wait": True,
            "wait_timeout_s": CLUSTER_TIMEOUT_S})
        sweep_s = time.perf_counter() - t0
        if sweep.get("state") != "done":
            raise AssertionError(f"phase 24: the audit sweep {sweep}")
        windows.append(cluster_window(rep, paths0, device,
                                      "WhatIsAllowedBatch and the sweep"))
        manager = AuditSweepManager(evaluator, chunk_size=256,
                                    out_dir=os.path.join(work, "direct"))
        try:
            t0 = time.perf_counter()
            job = manager.start_sweep(lattice=CLUSTER_LATTICE, wait=True,
                                      wait_timeout=CLUSTER_TIMEOUT_S)
            direct_s = time.perf_counter() - t0
        finally:
            manager.stop()
        diff = diff_snapshots(sweep["snapshot"], job.snapshot_path)
        if job.state != "done" or diff["cells_changed"] != 0 \
                or sweep["summary"] != job.status()["summary"]:
            raise AssertionError(f"phase 24: the routed sweep differs from "
                                 f"the direct sweep: {diff}")
        out["launches"] = {k: sum(w["launches"][k] for w in windows)
                           for k in kmod.LAUNCHES}
        missing = [k for k in CLUSTER_KERNELS if out["launches"][k] < 1]
        if device.type == "cuda" and missing:
            raise AssertionError(f"phase 24: the cluster path launched no "
                                 f"{missing}")
        out["windows"] = windows
        out["audit"] = {"cells": sweep["cells_total"], "sweep_s": sweep_s,
                        "cells_per_s": sweep["cells_total"] / sweep_s,
                        "direct_s": direct_s, "summary": sweep["summary"]}
        log(f"  {GRPC_WIA_QUERIES} WhatIsAllowedBatch queries and an "
            f"audit_sweep through the router on {card}: "
            f"{sweep['cells_total']} cells in {sweep_s:.2f} s "
            f"({out['audit']['cells_per_s']:.1f} cells/s, BULK-class "
            f"through a replica's batcher), equal to the direct-mode sweep "
            f"here ({direct_s:.2f} s): diff_snapshots empty, summary "
            f"{json.dumps(sweep['summary'])}; launches per replica (counts "
            f"set to 0 before the queries) "
            f"{json.dumps(windows[1]['launches_by_replica'])}, paths "
            f"{json.dumps(windows[1]['paths'])}; the cluster path's "
            f"launches in all {json.dumps(out['launches'])}")

        # the errors of the whole phase
        errs = {a: error_counts(m["paths"])
                for a, m in rep.each("metrics").items()}
        errs.update({f"{a} (before the restart)": e
                     for a, e in errors.items()})
        status = cluster.router.status()
        bad = {k: status[k] for k in ("retries", "unroutable") if status[k]}
        bad.update({r["addr"]: {k: r[k] for k in ("failures", "sheds")
                                if r[k]}
                    for r in status["replicas"] if r["failures"]
                    or r["sheds"]})
        if any(errs.values()) or bad:
            raise AssertionError(f"phase 24: error counts {errs}, router "
                                 f"{bad}")
        log(f"  every replica's error, hang-fallback and degraded count 0; "
            f"the router retried, shed and failed nothing "
            f"(router overhead {json.dumps(status['router_overhead'])})")
    finally:
        rep.close()
        t0 = time.perf_counter()
        cluster.stop()
        out["stop_s"] = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)

    # the oracle checks, after the cluster's threads are gone
    threads = [t.name for t in threading.enumerate()
               if t is not threading.current_thread()
               and not t.name.startswith(FORK_SAFE_THREADS)]
    t0 = time.perf_counter()
    idx = sorted(random.Random(3).sample(range(rows), min(32, rows)))
    for i, want in zip(idx, oracle_walks(engine, reqs, idx)):
        if _pb_key(got[i]) != _pb_key(tg.response_to_pb(want)):
            raise AssertionError(f"phase 24 row {i}: {_pb_key(got[i])} != "
                                 f"the oracle")
    acl_got = pb.BatchResponse.FromString(acl_raw).responses
    aidx = sorted(set(random.Random(5).sample(range(len(acl)), 32))
                  | set(acl_rows))
    for i, want in zip(aidx, oracle_walks(engine, acl, aidx)):
        if _pb_key(acl_got[i]) != _pb_key(tg.response_to_pb(want)):
            raise AssertionError(f"phase 24 ACL row {i}: != the oracle")
    wgot = pb.BatchReverseQuery.FromString(wraw).responses
    widx = range(len(wreqs))
    for i, want in zip(widx, oracle_walks(engine, wreqs, widx,
                                          reverse=True)):
        if wgot[i].SerializeToString() != tg.reverse_query_to_pb(
                want).SerializeToString():
            raise AssertionError(f"phase 24 whatIsAllowed {i}: != "
                                 "engine.what_is_allowed")
    out["checks_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  32 sampled rows of the routed batch and {len(aidx)} of the ACL "
        f"batch (its ACL rows among them) equal to the oracle, every "
        f"whatIsAllowed answer equal to engine.what_is_allowed "
        f"({out['checks_s']:.1f} s; oracle walks so far "
        f"{json.dumps(ORACLE_WALKS)}, other threads {threads}); the "
        f"cluster stopped in "
        f"{out['stop_s']:.1f} s; phase 24 took {out['phase_s']:.1f} s on "
        f"{card}")
    return out


# phase 25: the mesh layouts behind the Worker, each a world of
# MESH_RANKS ranks sharing the card over gloo, every rank started through
# the entry point
MESH_RANKS = 4
MESH_TIMEOUT_S = 300.0      # a world's boot, a visibility, a stop
MESH_WARM_CALLS = 3         # timed calls of worlds two and three
# (label, parallel block, tree, the kernels its path must launch)
MESH_WORLDS = (
    ("pod_shards (1,4)", {"pod_shards": 4}, "serve-20k",
     ("set_chunk", "shard_tail", "wia_planes")),
    ("model_devices (2,2)", {"model_devices": 2, "data_devices": 2},
     "shard-scale", ("rule_chunk", "shard_tail")),
    ("data_devices (4,1)", {"data_devices": 4}, "scoped_511",
     ("decide_dense",)),
)


def world_docs(tree: str, n_rules: int) -> dict:
    """A world's tree as the policy store keeps it: ``serve-20k`` and
    ``shard-scale`` the seed data's documents then ``stress_doc(n_rules)``'s
    (what phases 22 / 24 and 15 hold), ``scoped_511`` the scoped stress
    tree alone."""
    if tree == "scoped_511":
        sets, policies, rules = store_docs(stress_doc(n_rules, scoped=True))
        return {"rules": rules, "policies": policies, "policy_sets": sets}
    return cluster_seed(n_rules)


def mesh_world(device, block: dict, docs: dict, base: str):
    """A ``MeshWorld`` on ``docs`` (a ``database:snapshot_dir`` the store
    loads at start) with the ``parallel`` block and phase 22's stage
    histograms, started (rank 0 serves)."""
    from access_control_srv_tpu_torch.parallel.cluster import MeshWorld

    snap = os.path.join(base, "db")
    os.makedirs(snap, exist_ok=True)
    for kind, key in (("rule", "rules"), ("policy", "policies"),
                      ("policy_set", "policy_sets")):
        with open(os.path.join(snap, f"{kind}.json"), "w") as fh:
            json.dump(docs[key], fh)
    cfg = {"policies": {"type": "database"},
           "database": {"snapshot_dir": snap}, "parallel": block,
           "observability": {"enabled": True, "tracing": {
               "enabled": True, "sample_rate": 0.0}}}
    world = MeshWorld(cfg, MESH_RANKS, os.path.join(base, "cfg"),
                      device=str(device), timeout_s=MESH_TIMEOUT_S)
    atexit.register(world.stop)
    return world.start()


def single_device_bytes(ev, msgs: list[bytes]) -> bytes:
    """The ``IsAllowedBatch`` bytes a single-device port Worker on
    ``ev`` answers: the native wire rows, the rest through
    ``is_allowed_batch``, framed by the transport's own functions."""
    from access_control_srv_tpu_torch.srv import transport_grpc as tg

    responses, rows, reqs = tg.decode_native_rows(
        msgs, ev.is_allowed_batch_wire(msgs))
    for b, resp in zip(rows, ev.is_allowed_batch(reqs)):
        responses[b] = tg.response_to_pb(resp)
    return tg.serialize_batch_response(responses)


class WorldChannel(Replicas):
    """Calls and Commands to a world's rank 0."""

    def __init__(self, world):
        super().__init__(None)
        self.world = world

    @property
    def addrs(self) -> list:
        return [self.world.addr]

    def rank0(self, name: str, payload=None) -> dict:
        return self.command(self.world.addr, name, payload)

    def ac(self, method: str, payload: bytes) -> bytes:
        return self.call(self.world.addr, method, payload)


def mesh_window(ch: WorldChannel, batches: int) -> dict:
    """The launches (summed over the ranks) and each rank's collectives
    since the counts were set to 0, per kernel batch of the window."""
    got = ch.rank0("kernel_launches")
    colls = [r["collectives"] for r in got["by_rank"]]
    return {"launches": got["launches"],
            "launches_by_rank": [{k: v for k, v in r["launches"].items() if v}
                                 for r in got["by_rank"]],
            "collectives_per_batch": [
                {k: v / max(1, batches) for k, v in c.items()}
                for c in colls]}


def mesh_visibility(ch: WorldChannel, label: str, msg, probe: bytes,
                    want: int, card: str) -> dict:
    """A rule ``Update`` through rank 0, then the time until every rank
    reports one new table fingerprint and the probe batch answers
    ``want`` on every row (every rank's kernel on the patched tables);
    ``delta_stats`` counted one patch."""
    pb = ch.pb
    before = ch.rank0("health_check")["policy_update"]
    old = set(ch.rank0("program_identity")["mesh"]["table_fingerprints"])
    t0 = time.perf_counter()
    status = pb.MutationResponse.FromString(ch.call(
        ch.world.addr, "Update", pb.RuleList(items=[msg])
        .SerializeToString(), prefix="/acstpu.RuleService/")
    ).operation_status
    rpc_ms = (time.perf_counter() - t0) * 1e3
    if status.code != 200:
        raise AssertionError(f"phase 25 {label}: {status}")
    polls = 0
    while True:
        polls += 1
        fps = ch.rank0("program_identity")["mesh"]["table_fingerprints"]
        if len(set(fps)) == 1 and not set(fps) & old:
            got = pb.BatchResponse.FromString(ch.ac("IsAllowedBatch", probe))
            if all(r.decision == want for r in got.responses):
                break
        if time.perf_counter() - t0 > MESH_TIMEOUT_S:
            raise AssertionError(f"phase 25 {label}: not visible on every "
                                 f"rank in {MESH_TIMEOUT_S} s: {fps}")
    vis_ms = (time.perf_counter() - t0) * 1e3
    after = ch.rank0("health_check")["policy_update"]
    moved = delta_moved(before, after)
    if moved != {"patches": 1, "recompiles_avoided": 1}:
        raise AssertionError(f"phase 25 {label}: delta_stats moved {moved}")
    log(f"  rule {label} through rank 0's RuleService on {card}: the RPC "
        f"{rpc_ms:.1f} ms, then every rank on one new table fingerprint "
        f"({fps[0]}) and the probe {pb.Decision.Name(want)} after "
        f"{vis_ms:.1f} ms (time to visibility on all ranks, {polls} polls); "
        f"delta_stats moved {json.dumps(moved)}")
    return {"rpc_ms": rpc_ms, "visibility_ms": vis_ms, "polls": polls,
            "fingerprint": fps[0]}


def phase_mesh_worker(device, card: str, serve_pre,
                      direct_rate: float, n_rules: int = SERVE_RULES,
                      rows: int = SERVE_ROWS,
                      shard_rules: int = SHARD_RULES,
                      shard_rows: int = SHARD_ROWS) -> dict:
    """Phase 25 (the module docstring's item 25): the three worlds, one
    after another, each booted after its single-device yardstick and
    stopped before the next boots."""
    from access_control_srv_tpu_torch import native
    from access_control_srv_tpu_torch.srv import transport_grpc as tg

    t_phase = time.perf_counter()
    if device.type == "cuda":
        cuda_build.build(list(SOURCES))
    native.load()
    built = build_dir_state()
    work = tempfile.mkdtemp(prefix="acs-mesh-")
    atexit.register(shutil.rmtree, work, True)
    sizes = {"serve-20k": n_rules, "shard-scale": shard_rules,
             "scoped_511": 511}
    engine, evaluator, _ = serve_pre
    out: dict = {"worlds": {}, "launches": {k: 0 for k in kmod.LAUNCHES}}
    oracle_checks = []
    for label, block, tree, kernels in MESH_WORLDS:
        t_world = time.perf_counter()
        # the world's rows and single-device yardstick
        if tree == "serve-20k":
            eng, ev = engine, evaluator
            reqs = stress_traffic(rows, seed=11)
        elif tree == "shard-scale":
            eng = engine_for("seed_data")
            for ps in load_policy_sets(stress_doc(shard_rules)):
                eng.update_policy_set(ps)
            ev = HybridEvaluator(eng, device=device)
            reqs = stress_traffic(shard_rows, seed=SHARD_SEED)
        else:
            eng = engine_for("scoped_511")
            ev = HybridEvaluator(eng, device=device)
            reqs = grid_requests(random.Random(5), shard_rows, stress=True)
        msgs = [wire_bytes(r) for r in reqs]
        payload = batch_envelope(msgs)
        want = single_device_bytes(ev, msgs)
        world = mesh_world(device, block, world_docs(tree, sizes[tree]),
                           os.path.join(work, tree))
        ch = WorldChannel(world)
        res: dict = {"tree": tree, "rows": len(reqs),
                     "boot_s": world.ready_at - world.spawned_at}
        try:
            ident = ch.rank0("program_identity")
            fps = ident["mesh"]["table_fingerprints"]
            if len(fps) != MESH_RANKS or len(set(fps)) != 1:
                raise AssertionError(f"phase 25 {label}: the ranks' table "
                                     f"fingerprints at boot {fps}")
            ch.rank0("kernel_launches", {"reset": True})
            ch.rank0("stage_stats", {"clear": True})
            first = ch.ac("IsAllowedBatch", payload)
            if first != want:
                raise AssertionError(f"phase 25 {label}: the first answer "
                                     "differs from the single device's")
            calls = MESH_WARM_CALLS if tree != "serve-20k" else WIRE_BATCHES
            t0 = time.perf_counter()
            warm = [ch.ac("IsAllowedBatch", payload) for _ in range(calls)]
            dt = (time.perf_counter() - t0) / calls
            if any(w != want for w in warm):
                raise AssertionError(f"phase 25 {label}: a warm answer "
                                     "differs from the single device's")
            res.update(calls=calls, batch_ms=dt * 1e3,
                       decisions_per_s=len(reqs) / dt,
                       stages=ch.rank0("stage_stats")["stages"])
            batches = 1 + calls
            got = ch.pb.BatchResponse.FromString(first).responses
            oracle_checks.append((label, eng, reqs, got, ()))
            if tree == "serve-20k":
                acl = stress_traffic(1024, seed=37, n_acl=16)
                acl_msgs = [wire_bytes(r) for r in acl]
                acl_rows = [i for i, r in enumerate(acl)
                            if any((x.get("meta") or {}).get("acls")
                                   for x in r.context.get("resources") or [])]
                acl_raw = ch.ac("IsAllowedBatch", batch_envelope(acl_msgs))
                if acl_raw != single_device_bytes(ev, acl_msgs):
                    raise AssertionError(f"phase 25 {label}: the ACL batch "
                                         "differs from the single device's")
                batches += 1
                oracle_checks.append((label + " ACL", eng, acl,
                                      ch.pb.BatchResponse.FromString(
                                          acl_raw).responses, acl_rows))
            res.update(mesh_window(ch, batches))
            if tree == "serve-20k":
                res["crud"] = mesh_crud(ch, label, card)
                wreqs = stress_traffic(GRPC_WIA_QUERIES, seed=29)
                ch.rank0("kernel_launches", {"reset": True})
                wraw = ch.ac("WhatIsAllowedBatch", batch_envelope(
                    [wire_bytes(r) for r in wreqs]))
                wgot = ch.pb.BatchReverseQuery.FromString(wraw).responses
                wwant = ev.what_is_allowed_batch(clone(wreqs))
                if [w.SerializeToString() for w in wgot] != [
                        tg.reverse_query_to_pb(w).SerializeToString()
                        for w in wwant]:
                    raise AssertionError(f"phase 25 {label}: whatIsAllowed "
                                         "differs from the single device's")
                wia = ch.rank0("kernel_launches")["launches"]
                res["wia_launches"] = {k: v for k, v in wia.items() if v}
                for k, v in wia.items():
                    res["launches"][k] += v
            errs = error_counts(ch.rank0("metrics")["paths"])
            if errs:
                raise AssertionError(f"phase 25 {label}: error counts {errs}")
            missing = [k for k in kernels if not res["launches"].get(k)]
            if device.type == "cuda" and missing:
                raise AssertionError(f"phase 25 {label}: the path launched "
                                     f"no {missing}")
            if build_dir_state() != built:
                raise AssertionError(f"phase 25 {label}: a rank built a "
                                     "library (the files under _build/ "
                                     "changed)")
            res["channel"] = ch.rank0("program_identity")["mesh"]["channel"]
        finally:
            ch.close()
            t0 = time.perf_counter()
            world.stop(timeout_s=MESH_TIMEOUT_S)
            res["stop_s"] = time.perf_counter() - t0
        if any(p.returncode != 0 for p in world.procs):
            raise AssertionError(f"phase 25 {label}: exit codes "
                                 f"{[p.returncode for p in world.procs]}")
        for k, v in res["launches"].items():
            out["launches"][k] += v
        res["world_s"] = time.perf_counter() - t_world
        out["worlds"][label] = res
        ch_stats = res["channel"]
        log(f"  {label} on {tree} ({len(reqs)} rows): {MESH_RANKS} ranks "
            f"(python -m access_control_srv_tpu_torch --device {device}, "
            f"gloo, one card, the only world up) ready "
            f"{res['boot_s']:.1f} s after the spawn; "
            f"every answer byte-equal to the single-device port's; "
            f"{res['decisions_per_s']:.0f} decisions/s over {res['calls']} "
            f"warm IsAllowedBatch calls ({res['batch_ms']:.3f} ms a call) "
            f"against phase 22's direct {direct_rate:.0f} on {card}; "
            f"launches summed over the ranks "
            f"{json.dumps({k: v for k, v in res['launches'].items() if v})} "
            f"(by rank {json.dumps(res['launches_by_rank'])}); collectives "
            f"per kernel batch by rank "
            f"{json.dumps(res['collectives_per_batch'])}; the follower "
            f"channel: {ch_stats['batches']} batches, "
            f"{ch_stats['batch_bytes'] / max(1, ch_stats['batches']):.0f} "
            f"bytes and {ch_stats['batch_s'] * 1e3 / max(1, ch_stats['batches']):.3f} "
            f"ms a batch, {ch_stats['messages']} messages in all; stopped in "
            f"{res['stop_s']:.1f} s, every rank's exit code 0; no file under "
            f"_build/ changed; error, shed and degraded counts 0")
        log(f"    stages (rank 0, ms) on {card}: "
            f"{json.dumps(stage_view(res['stages']))}")
        if ev is not evaluator:
            del ev
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    n_oracle = 0
    for label, eng, reqs, got, always in oracle_checks:
        idx = sorted(set(random.Random(3).sample(range(len(reqs)), 32))
                     | set(always))
        for i, want in zip(idx, oracle_walks(eng, reqs, idx)):
            if _pb_key(got[i]) != _pb_key(tg.response_to_pb(want)):
                raise AssertionError(f"phase 25 {label} row {i}: != the "
                                     "oracle")
        n_oracle += len(idx)
    out["checks_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  {n_oracle} sampled rows of the worlds' first batches (the ACL "
        f"rows among them) equal to the oracle ({out['checks_s']:.1f} s); "
        f"phase 25 took {out['phase_s']:.1f} s on {card}")
    return out


def stage_view(stages: dict) -> dict:
    """p50 ms per stage of a ``stage_stats`` snapshot."""
    return {k: v.get("p50_s") and round(v["p50_s"] * 1e3, 4)
            for k, v in sorted(stages.items()) if v.get("count")}


def mesh_crud(ch: WorldChannel, label: str, card: str) -> dict:
    """World one's patch: ``CRUD_RULE``'s subject flipped to a probe
    role and back through rank 0, each visible on every rank."""
    pb = ch.pb
    rs = "/acstpu.RuleService/"
    original = pb.RuleListResponse.FromString(ch.call(
        ch.world.addr, "Read", pb.ReadRequest(ids=[CRUD_RULE])
        .SerializeToString(), prefix=rs)).items[0]
    flipped = pb.Rule()
    flipped.CopyFrom(original)
    flipped.target.subjects[0].value = "probe-role"
    probe = clone(stress_traffic(1, seed=31)[0])
    probe.target.subjects[0].value = "probe-role"
    probe.context["subject"]["role_associations"][0]["role"] = "probe-role"
    probe.target.resources[0].value = original.target.resources[0].value
    probe.target.actions[0].value = original.target.actions[0].value
    probe_batch = batch_envelope([wire_bytes(probe)] * CLUSTER_PROBE_ROWS)
    return {step: mesh_visibility(ch, f"{CRUD_RULE} {step}", msg,
                                  probe_batch, want, card)
            for step, msg, want in (("flip", flipped, pb.PERMIT),
                                    ("flip-back", original,
                                     pb.INDETERMINATE))}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    stats = {"max_abs_err": 0}
    sig_stats: dict = {}
    t_start = time.perf_counter()

    def stamp(msg: str) -> None:
        """A phase's heading with the seconds since the start."""
        log(f"{msg} [{time.perf_counter() - t_start:.1f} s]")

    stamp("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    log(card)

    stamp("phase 2: build")
    quick = "--quick" in argv
    # while the nvcc processes run, this thread does the host work of the
    # largest trees (load, compile, table upload; no kernel library is
    # needed before a first batch): phase 7's two 100k-rule trees and,
    # in the full run, phase 13's tuple store and closure fold
    built: dict = {}

    def build() -> None:
        t0 = time.perf_counter()
        try:
            cuda_build.build(list(SOURCES))
        except BaseException as err:  # noqa: BLE001 — raised below
            built["error"] = err
        built["s"] = time.perf_counter() - t0

    builder = threading.Thread(target=build, name="nvcc")
    builder.start()
    t0 = time.perf_counter()
    trees = {"a": sig_tree(device, False), "b": sig_tree(device, True)}
    rebac_pre = None if quick else rebac_tree(device)
    # phase 24's broker and its seeded journal (no replica: they load
    # the libraries being built)
    tier = None if quick else cluster_tier(device)
    host_s = time.perf_counter() - t0
    builder.join()
    if "error" in built:
        raise built["error"]
    also = "" if quick else (", the rebac-serve store and phase 24's "
                             "seeded broker")
    log(f"  {', '.join(SOURCES)} built in {built['s']:.1f} s (one nvcc "
        f"each, in parallel); meanwhile the 100k trees{also} were built in "
        f"{host_s:.1f} s")
    parent_csrc = parent_dir = None
    if "--parent-csrc" in argv:
        parent_csrc = argv[argv.index("--parent-csrc") + 1]
        parent_dir = tempfile.mkdtemp(prefix="acs-parent-")
        atexit.register(shutil.rmtree, parent_dir, True)
    ptx = phase_ptxas(parent_csrc, parent_dir)
    if parent_csrc:
        # the parent's K3 / K4, timed beside the new on the same arguments
        global PARENT
        PARENT = load_parent(parent_csrc, parent_dir)
    # --quick: the plane kernels' phases only (2, 6, 7, 9-12 and the K2 /
    # K5 report), no kernel table and no result line
    if not quick:
        stamp("phase 3-4: dense kernel vs plain version, kernel vs oracle")
        variants = phase_kernel_vs_plain(device, 1024, stats)
        for flags, n in sorted(variants.items()):
            log(f"  variant (with_acl, with_hr, with_rel)={flags}: {n} rows "
                f"checked")

        stamp("phase 5: dense main path (HybridEvaluator.is_allowed_batch, "
            "511 rules)")
        phase_end_to_end(device, 4096, stats)

    stamp("phase 6: signature kernels vs plain versions")
    phase_sig_vs_plain(device, sig_stats)

    stamp("phase 7: signature main paths (100k rules)")
    sig = phase_sig_main(device, sig_stats, card, trees)
    if quick:
        tree_100k = sig.pop("tree_100k")
        stamp("phase 9: wia_planes vs plain version")
        wia = phase_wia_vs_plain(device, sig_stats, tree_100k)
        del tree_100k
        stamp("phase 10: whatIsAllowed main path")
        wl = phase_wia_main(device, sig_stats, card)
        stamp("phase 11: lattice sweep")
        lat = phase_lattice(device, sig_stats, card)
        stamp("phase 12: relation variants vs plain versions")
        rel = phase_rel_vs_plain(device, sig_stats)
        stamp("K2 / K5 report (sig_planes, wia_planes):")
        planes_report(planes_cases(sig, rel, wia, wl, lat), ptx, card,
                      sig_stats)
        stamp("phase 19: the wire main path (serve-20k, (a), scoped_511)")
        wire = phase_wire(device, sig_stats, card, sig.pop("wire_a"))
        stamp("phase 22: the gRPC main path (serve-20k over loopback)")
        phase_grpc(device, sig_stats, card,
                   wire["serve-20k"]["decisions_per_s"])
        stamp("phase 23: hot policy updates at scoped_511 (K1 on patched "
              "tables, the prefilter threshold)")
        phase_hot_updates(device, sig_stats, card)
        log(f"  quick run: {time.perf_counter() - t_start:.1f} s in all")
        return 0

    stamp("phase 8: throughput")
    seed = phase_throughput(device, "seed_data", 1 << 18, card)
    scoped = phase_throughput(device, "scoped_511", 1 << 16, card)
    e2e = stats["e2e"]
    log(f"  dense evaluator end to end: {e2e['decisions_per_s']:.0f} "
        f"decisions/s at {e2e['rows']} rows ({e2e['seconds'] * 1e3:.3f} ms "
        f"per batch) on {card}")
    log(f"  dense evaluator batch stages (ms): {json.dumps(e2e['stages_ms'])}")
    log(f"  decide_dense: {seed['kernel_decisions_per_s']:.0f} decisions/s "
        f"(seed, 2^18 rows), {scoped['kernel_decisions_per_s']:.0f} "
        f"decisions/s (scoped_511, 2^16 rows) on {card}")
    for key, label in (("a", "stress 100k, 16384 rows"),
                       ("b", "stress HR 100k, 8192 rows")):
        st = sig[key]["steady"]
        log(f"  signature evaluator ({label}): {st['decisions_per_s']:.0f} "
            f"decisions/s ({st['batch_ms']:.3f} ms per batch), stages (ms) "
            f"{json.dumps(st['stages_ms'])} on {card}")

    stamp("phase 9: wia_planes vs plain version (fixtures, 1k, 10k, 100k)")
    tree_100k = sig.pop("tree_100k")
    wia = phase_wia_vs_plain(device, sig_stats, tree_100k)

    stamp("phase 10: whatIsAllowed main path (wia-large, 1,000 rules, "
        "2,048 queries)")
    wl = phase_wia_main(device, sig_stats, card)

    stamp("phase 11: lattice sweep (128 x 128 x 1 on 10,000 rules)")
    lat = phase_lattice(device, sig_stats, card)

    stamp("phase 12: relation variants vs plain versions (fixture, 720 rules)")
    rel = phase_rel_vs_plain(device, sig_stats)

    stamp("phase 13: ReBAC main path (rebac-serve, 1,000,000 tuples)")
    rebac = phase_rebac(device, sig_stats, card, rebac_pre)
    del rebac_pre

    stamp("phase 14: rule_chunk, set_chunk, shard_tail vs plain versions "
        "(shard-scale, 100k, fixtures; 4 shards)")
    phase_shard_vs_plain(device, sig_stats, tree_100k)
    del tree_100k

    stamp("phase 15: HybridEvaluator on meshes, 4 ranks sharing the card "
        "(gloo)")
    later: dict = {}
    # the host work of phases 18-21's trees meanwhile
    p15 = phase15(card, meanwhile=lambda: later.update(
        explain=explain_tree(device), serve=serve_tree(device),
        token=token_mix_tree(device), adapter=adapter_tree(device)))

    stamp("phase 16: NCCL, world size 1")
    phase16(card)

    stamp("phase 17: explain variants vs plain versions (fixtures, 511, "
        "720, relation, shard-scale partitions)")
    phase_explain_vs_plain(device, sig_stats)

    stamp("phase 18: explain main path (explain-overhead: 20,000 rules, "
        "8 x 4,096 rows)")
    expl = phase_explain_main(device, sig_stats, card,
                              later.pop("explain"))

    stamp("K3 / K4 report (CUDA events: the mean of "
        f"{ITERS} launches through the wrapper, and the median of "
        f"{STEADY_WINDOWS} windows of {STEADY_ITERS} launches of arguments "
        "packed once):")
    redesign_report(sig, expl, ptx, card)
    stamp("K1 / K6 / K8 report (the rows program; CUDA events as above):")
    rows_t = rows_report(rows_cases(device, stats, rebac), ptx, card,
                         sig_stats)
    stamp("K7 / tail report (rule_chunk and shard_tail; CUDA events as "
        "above):")
    rows_t.update(rows_report(k7_cases(device), ptx, card, sig_stats))
    stamp("K2 / K5 report (sig_planes and wia_planes; CUDA events as "
        "above):")
    planes_t = planes_report(planes_cases(sig, rel, wia, wl, lat), ptx,
                             card, sig_stats)

    log("  relation variants' times (CUDA events, 5 launches after a "
        "warm-up):")
    rel_rows = {"decide_dense": dict(rebac["k1"]),
                "sig_planes": dict(planes_t[
                    "sig_planes relation-720 "
                    f"({int(rel['sig_planes'][3])},1)"],
                    launches=rel["launches"]["sig_planes"])}
    for name, key in (("sig_decide", "launches"),
                      ("decide_grouped", "launches_acl")):
        rel_rows[name] = time_kernel(name, rel[name])
        rel_rows[name]["launches"] = rel[key][name]
        log(f"  {name} with_rel (720 relation tree) on {card}: "
            + json.dumps(rel_rows[name]))
    stamp("phase 19: the wire main path (is_allowed_batch_wire: serve-20k, "
          "(a), scoped_511; deep HR through the ceiling)")
    serve = later.pop("serve")
    wire = phase_wire(device, sig_stats, card, sig.pop("wire_a"), serve)
    stamp("phase 20: token-mix (prepare_batch, 10,000 rules, 8,192 rows "
          "over 512 tokens)")
    phase_token_mix(device, sig_stats, card, later.pop("token"))
    stamp("phase 21: adapter-mixed-warm (decision cache, 10,008 rules, "
          "8,192 rows)")
    phase_adapter_warm(device, sig_stats, card, later.pop("adapter"))
    stamp("phase 22: the gRPC main path (Worker, GrpcServer and client over "
          "loopback: serve-20k)")
    grpc_out = phase_grpc(device, sig_stats, card,
                          wire["serve-20k"]["decisions_per_s"])
    stamp("phase 23: hot policy updates at scoped_511 (K1 on patched "
          "tables, the prefilter threshold)")
    hot = phase_hot_updates(device, sig_stats, card)
    stamp("phase 24: the cluster tier (LocalCluster: a broker, "
          f"{CLUSTER_REPLICAS} replicas on the card, the router; serve-20k)")
    clus = phase_cluster(device, sig_stats, card, serve,
                         grpc_out["decisions_per_s"], tier)
    stamp("phase 25: the mesh layouts behind the Worker (4 ranks on the "
          "card through the entry point: pod_shards (1,4) on serve-20k, "
          "model_devices (2,2) on shard-scale, data_devices (4,1) on "
          "scoped_511)")
    mesh = phase_mesh_worker(device, card, serve,
                             grpc_out["decisions_per_s"])
    del serve
    stats["max_abs_err"] = max(stats["max_abs_err"], sig_stats.get(
        "decide_dense", {}).get("max_abs_err", 0))
    log(f"  launches: wia-large first batch {wl['launches']['wia_planes']}, "
        f"warm 0; lattice warm sweep {lat['warm_launches']}, timed sweep "
        f"{lat['timed_launches']}")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        f"on {card}")
    log(f"  oracle walks of the checks: {json.dumps(ORACLE_WALKS)}")
    log(f"  sources: {json.dumps(list(SOURCES))}; "
        f"{time.perf_counter() - t_start:.1f} s in all")

    main_stats = stats["main"]
    rows = [{
        "name": "decide_dense", "launches": main_stats["launches"],
        "max_abs_err": stats["max_abs_err"], **{
            k: main_stats[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "yardstick_ms")},
    }]
    for name, key, t in (
            ("sig_planes", "a", planes_t["sig_planes (a)"]),
            ("sig_decide", "a", sig["a"]["sig_decide"]),
            ("decide_grouped", "c", sig["c"]["decide_grouped"])):
        rows.append({
            "name": name, "launches": sig[key]["launches"][name],
            "max_abs_err": sig_stats[name]["max_abs_err"],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            **{k: t[k] for k in PACKED_KEYS + PLANES_KEYS if k in t},
        })
    t = planes_t["wia_planes wia-large"]
    rows.append({
        "name": "wia_planes", "launches": wl["launches"]["wia_planes"],
        "max_abs_err": sig_stats["wia_planes"]["max_abs_err"],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        **{k: t[k] for k in PACKED_KEYS + PLANES_KEYS if k in t},
    })
    rows[0]["k6"] = {"replaces": K6_REPLACES, **sharded_row(
        p15, "decide_dense", "K6"), "library_ms": None}
    # the K7 / K8 rows: the slowest rank's launch at (1, 4) of the main
    # path, the launches and errors of both layouts of their program on
    # all ranks
    rows.append({"name": "rule_chunk", **sharded_row(p15, "rule_chunk",
                                                      "K7")})
    rows.append({"name": "set_chunk", **sharded_row(p15, "set_chunk",
                                                     "K8")})
    rows.append({"name": "shard_tail", **sharded_row(p15, "shard_tail",
                                                      "K7"),
                 "pod": {"replaces": TAIL_ALSO_REPLACES, **sharded_row(
                     p15, "shard_tail", "K8"), "library_ms": None}})
    # the redesigned kernels' packed-once and parent times (explain off):
    # the reports' scoped_511 and (1,4) cells
    by_name = {r["name"]: r for r in rows}
    for r, cell in ((rows[0], "scoped_511"),
                    (by_name["set_chunk"], "set_chunk(1,4)"),
                    (by_name["rule_chunk"], "rule_chunk(1,4)"),
                    (by_name["shard_tail"], "shard_tail K7(1,4)"),
                    (by_name["shard_tail"]["pod"], "shard_tail K8(1,4)")):
        t = rows_t[cell]
        sfx = "_explain_off" if "kernel_ms_explain_off" in t else ""
        r.update({k: t[k + sfx] for k in PACKED_KEYS if k + sfx in t})
    keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by")
    extra = ("ms_explain_off",) + PACKED_KEYS + tuple(
        k + "_explain_off" for k in PACKED_KEYS)
    # the explain variants: K3 / K4 on phase 18's main path, K1 on the
    # explain K6 layout of phase 15, K8's set_chunk and both tails on the
    # explain K7 / K8 layouts
    explain_rows = {
        "decide_dense": sharded_row(p15, "decide_dense", "K6", True),
        "sig_decide": {**expl["sig_decide"]},
        "decide_grouped": {**expl["decide_grouped"]},
        "set_chunk": sharded_row(p15, "set_chunk", "K8", True),
        "shard_tail": sharded_row(p15, "shard_tail", "K7", True),
    }
    for name in ("decide_dense", "sig_decide", "decide_grouped"):
        explain_rows[name]["max_abs_err"] = max(
            explain_rows[name].get("max_abs_err", 0),
            sig_stats[name].get("explain_err", 0))
    for name in ("set_chunk", "shard_tail"):
        explain_rows[name]["max_abs_err"] = max(
            explain_rows[name]["max_abs_err"],
            sig_stats[name + "+explain"]["max_abs_err"])
    pod_explain = sharded_row(p15, "shard_tail", "K8", True)
    patched_launches = dict(grpc_out["patched"]["launches"])
    for src in (hot["launches"], p15["patch"]["launches_all_ranks"]):
        for k, v in src.items():
            patched_launches[k] = patched_launches.get(k, 0) + v
    for r in rows:
        if r["name"] in explain_rows:
            t = explain_rows[r["name"]]
            r["explain"] = {"replaces": REPLACES_EXPLAIN[r["name"]],
                            "max_abs_err": t["max_abs_err"],
                            **{k: t[k] for k in keys}, "library_ms": None,
                            **{k: t[k] for k in extra if k in t}}
        if r["name"] == "shard_tail":
            r["pod"]["explain"] = {
                "replaces": EXPLAIN_TAIL_ALSO_REPLACES,
                "max_abs_err": max(pod_explain["max_abs_err"],
                                   sig_stats["shard_tail+explain"][
                                       "max_abs_err"]),
                **{k: pod_explain[k] for k in keys}, "library_ms": None}
        if r["name"] in wire["launches"]:
            # phase 19's launches, beside the main path's of phases 5 / 7
            r["wire"] = {"launches": wire["launches"][r["name"]]}
        if grpc_out["launches"].get(r["name"]):
            # phase 22's launches through the gRPC serving shell
            r["grpc"] = {"launches": grpc_out["launches"][r["name"]]}
        if clus["launches"].get(r["name"]):
            # phase 24's launches, summed over the replica processes
            r["cluster"] = {"launches": clus["launches"][r["name"]]}
        if mesh["launches"].get(r["name"]):
            # phase 25's launches, summed over the ranks of the worlds
            r["mesh_worker"] = {"launches": mesh["launches"][r["name"]]}
        if patched_launches.get(r["name"]):
            # launches on delta-patched tables (phases 15, 22, 23)
            r["patched"] = {"launches": patched_launches[r["name"]]}
        if r["name"] in rel_rows:
            t = rel_rows[r["name"]]
            r["with_rel"] = {
                "replaces": REPLACES_REL[r["name"]],
                "max_abs_err": sig_stats[r["name"]]["max_abs_err"],
                **{k: t[k] for k in keys}, "library_ms": None,
                **{k: t[k] for k in PACKED_KEYS + PLANES_KEYS if k in t}}
    print(json.dumps({"kernels": [{
        "name": r["name"], "route": "cuda",
        "source": CSRC + SOURCE[r["name"]] + ".cu",
        "replaces": REPLACES[r["name"]], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        **{k: r[k] for k in PACKED_KEYS + PLANES_KEYS + ("yardstick_ms",)
           if k in r},
        **({"with_rel": r["with_rel"]} if "with_rel" in r else {}),
        **{k: r[k] for k in ("explain", "k6", "pod", "wire", "grpc",
                             "patched", "cluster", "mesh_worker")
           if k in r},
    } for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
