"""Route rules and launch plans of the port's two-route kernels (K1-K5 in
``ops/cuda_attention.py``; K6, K7 in ``ops/cuda_matmul.py``).

The routes are chosen by dtype alone, and the tensor-core routes' launch
plans are pure functions of shapes and the SM count, so both are checked
here on the CPU, over grids of shapes: no empty split, k-tiles that never
straddle an int4 group, grids within two blocks an SM that still fill the
card where the shape allows, shared memory within a Hopper SM's 227 KB.
The kernels themselves run in ``tests/test_torch_cuda.py`` on a card.
"""

import itertools

import pytest
import torch

from llmq_tpu_torch.ops import _build
from llmq_tpu_torch.ops import cuda_attention as ca
from llmq_tpu_torch.ops import cuda_matmul as cm

pytestmark = pytest.mark.unit

SM_SMEM = 227 * 1024  # shared memory one Hopper SM gives its blocks
SMS = (132, 114, 8)  # an H100 SXM, an H100 PCIe, a small part


@pytest.mark.parametrize("x_dtype,route", [
    (torch.bfloat16, "tensor_core"), (torch.float32, "exact"),
])
def test_int4_route_is_a_function_of_the_activation_dtype(x_dtype, route):
    assert cm.int4_route(x_dtype) == route


@pytest.mark.parametrize("x_dtype,route", [
    (torch.bfloat16, "tensor_core"), (torch.float32, "exact"),
])
def test_int8_route_is_a_function_of_the_activation_dtype(x_dtype, route):
    assert cm.int8_route(x_dtype) == route


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (q, kv) for q in (torch.float32, torch.bfloat16)
    for kv in (torch.float32, torch.bfloat16, torch.float8_e5m2)
])
def test_fused_write_decode_takes_the_attention_route(monkeypatch, q_dtype, kv_dtype):
    """K4 launches the tensor-core kernel exactly where attention_route
    says so (bf16 q over a bf16 or e5m2 pool), else the exact one."""
    launched = []
    monkeypatch.setattr(ca, "_decode_tc", lambda *a, **k: launched.append("tensor_core"))
    monkeypatch.setattr(ca, "_paged_decode_v2", lambda *a, **k: launched.append("exact"))
    monkeypatch.setattr(ca, "_check_decode", lambda *a, **k: None)
    q = torch.zeros((2, 4, 64), dtype=q_dtype)
    pool = torch.zeros((1, 3, 8, 2, 64), dtype=kv_dtype)
    new = torch.zeros((2, 2, 64), dtype=q_dtype)
    table, ctx = torch.zeros((2, 1), dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    fn = ca.paged_decode_attention_v3_cuda
    before = {"tensor_core": fn.tensor_core_launches, "exact": fn.exact_launches}
    fn(q, pool, pool, new, new, table, ctx, scale=1.0, layer=0)
    route = ca.attention_route(q_dtype, kv_dtype)
    assert launched == [route]
    after = {"tensor_core": fn.tensor_core_launches, "exact": fn.exact_launches}
    assert {k: after[k] - before[k] for k in after} == {k: int(k == route) for k in after}


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (q, kv) for q in (torch.float32, torch.bfloat16)
    for kv in (torch.float32, torch.bfloat16, torch.float8_e5m2)
])
def test_chunked_decode_takes_the_attention_route(monkeypatch, q_dtype, kv_dtype):
    """K5 launches the tensor-core kernel, with a chunk of pages a ring
    stage, exactly where attention_route says so, else the exact one."""
    launched = []
    monkeypatch.setattr(ca, "_decode_tc", lambda *a, **k: launched.append(
        ("tensor_core", k["tiles_per_stage"])))
    monkeypatch.setattr(ca, "_paged_decode_v2", lambda *a, **k: launched.append(("exact", None)))
    monkeypatch.setattr(ca, "_check_decode", lambda *a, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    q = torch.zeros((16, 16, 128), dtype=q_dtype)
    pool = torch.zeros((1, 3, 32, 2, 128), dtype=kv_dtype)
    table, ctx = torch.zeros((16, 32), dtype=torch.int32), torch.ones(16, dtype=torch.int32)
    fn = ca.paged_decode_attention_v2_cuda
    before = {"tensor_core": fn.tensor_core_launches, "exact": fn.exact_launches}
    fn(q, pool, pool, table, ctx, scale=1.0, layer=0)
    route = ca.attention_route(q_dtype, kv_dtype)
    # qwen2.5-3b's decode shape: an e5m2 pool's double buffer of four
    # 32-key pages fits beside a second block, a bf16 pool's does not.
    tps = 2 if kv_dtype == torch.float8_e5m2 else 1
    assert launched == [(route, tps if route == "tensor_core" else None)]
    after = {"tensor_core": fn.tensor_core_launches, "exact": fn.exact_launches}
    assert {k: after[k] - before[k] for k in after} == {k: int(k == route) for k in after}


@pytest.mark.parametrize("page,pps,item,tps", [
    (32, 32, 1, 2), (32, 256, 1, 2), (32, 32, 2, 1), (16, 64, 1, 1), (8, 5, 1, 1),
])
def test_chunked_decode_stage_is_a_chunk_of_whole_pages(page, pps, item, tps):
    """K5's tiles a warp's stage holds: the 4 warps' stage is
    pages_per_chunk pages where that is 128 keys (2 tiles a warp) and a
    double buffer of them fits, else one tile a warp (K1's plan); a
    function of shapes and the SM count only."""
    for S, n_kv, d, size, sms in itertools.product((1, 16, 64), (2, 8), (64, 128, 256), (1, 2),
                                                   SMS):
        got = ca.decode_tc_tiles_per_stage(S, n_kv, page, pps, d, size, sms)
        assert 1 <= got <= ca.DECODE_TC_MAX_TPS
        plan = ca.decode_tc_plan(S, n_kv, pps * page, d, size, sms)
        ppc = ca.pages_per_chunk(page, d, size, -(-S * n_kv * plan["splits"] // sms),
                                 tensor_core=True)
        assert got == max(1, min(2, ppc * page // (ca.DECODE_TC_TILE * ca.DECODE_TC_WARPS)))
    assert ca.decode_tc_tiles_per_stage(16, 2, page, pps, 128, item, 132) == tps


def test_decode_tc_plan_with_chunk_stages_keeps_k1_splits():
    """K5's plan (two tiles a stage) has K1's splits, so their outputs
    agree bit for bit, and its ring still fits the SM's shared memory."""
    for S, n_kv, max_ctx, d, item, sms in itertools.product(
            (1, 16, 64), (1, 2, 8), (100, 1024, 8192, 32768), (64, 128, 256), (1, 2), SMS):
        k1 = ca.decode_tc_plan(S, n_kv, max_ctx, d, item, sms)
        k5 = ca.decode_tc_plan(S, n_kv, max_ctx, d, item, sms, tiles_per_stage=2)
        assert k5["splits"] == k1["splits"] and k5["stages"] in ca.DECODE_TC_STAGES
        assert k5["smem"] == ca.decode_tc_smem(d, item, k5["stages"], 2)
        assert k5["smem"] + 1024 <= SM_SMEM
        resident = min(2, -(-S * n_kv * k5["splits"] // sms))
        assert k5["stages"] == 1 or resident * (k5["smem"] + 1024) <= SM_SMEM


def test_split_count_never_exceeds_its_target_and_leaves_no_run_empty():
    for units, target, cap in itertools.product(range(0, 130), (1, 2, 3, 7, 9, 16, 33, 264),
                                                (8, 32)):
        n = _build.split_count(units, target, cap)
        assert 1 <= n <= max(1, min(target, cap, units))
        if units:
            per = -(-units // n)
            assert (n - 1) * per < units  # the last run holds at least one unit
            # at least half the target where there are units enough
            assert 2 * n >= min(target, cap, units)


def test_decode_tc_plan_invariants():
    for S, n_kv, max_ctx, d, item, sms in itertools.product(
            (1, 3, 16, 64), (1, 2, 4, 8), (16, 100, 1024, 8192, 32768), (64, 128, 256), (1, 2),
            SMS):
        plan = ca.decode_tc_plan(S, n_kv, max_ctx, d, item, sms)
        splits, stages = plan["splits"], plan["stages"]
        assert 1 <= splits <= ca.MAX_SPLITS and stages in ca.DECODE_TC_STAGES
        # the kernel's span for a row that fills the page map: whole 16-key
        # tiles, no split empty, at least one tile for each of the 4 warps
        span = ca.DECODE_TC_TILE * -(-(-(-max_ctx // ca.DECODE_TC_TILE)) // splits)
        assert (splits - 1) * span < max_ctx
        assert splits <= max(1, -(-max_ctx // (ca.DECODE_TC_TILE * ca.DECODE_TC_WARPS)))
        rows = S * n_kv
        blocks = rows * splits
        assert blocks <= max(2 * sms, rows)  # no SM holds a third block on average
        cap = min(ca.MAX_SPLITS, -(-max_ctx // (ca.DECODE_TC_TILE * ca.DECODE_TC_WARPS)))
        assert 2 * blocks >= min(2 * sms, rows * cap)  # fills the card where it can
        assert plan["smem"] == ca.decode_tc_smem(d, item, stages)
        assert plan["smem"] + 1024 <= SM_SMEM
        resident = min(2, -(-blocks // sms))
        assert stages == 1 or resident * (plan["smem"] + 1024) <= SM_SMEM


def test_int4_tc_plan_invariants():
    for M, N, K, item, sms in itertools.product(
            (1, 5, 16, 17, 64, 200, 1024), (30, 256, 2048, 4096, 11008),
            (32, 96, 200, 2048, 11008, 14336), (2, 4), SMS):
        plan = cm.int4_tc_plan(M, N, K, sms, item)
        kind, splits = plan["kind"], plan["splits"]
        assert kind == (0 if M <= cm.TC_DECODE_M else 1)
        tiles = -(-K // cm.TC_TILE_K)
        per = -(-tiles // splits)
        assert 1 <= splits <= cm.MAX_SPLITS and (splits - 1) * per < tiles  # none empty
        if tiles >= 2 * cm.TC_MIN_TILES_PER_SPLIT:
            assert per >= cm.TC_MIN_TILES_PER_SPLIT
        # runs of whole 64-row k-tiles: a group of 16, 32, 64 or 128 rows
        # never straddles a tile or a split boundary
        for g in (16, 32, 64, 128):
            assert all((s * per * cm.TC_TILE_K) % min(g, cm.TC_TILE_K) == 0
                       for s in range(splits))
        bm, bn = ((cm.TC_DECODE_M, cm.TC_DECODE_N) if kind == 0
                  else (cm.TC_PREFILL_M, cm.TC_PREFILL_N))
        mn = -(-M // bm) * -(-N // bn)
        per_sm = 2 if kind == 0 else 1
        assert mn * splits <= max(per_sm * sms, mn)
        assert plan["smem"] + 1024 <= SM_SMEM
        if kind == 0:
            assert plan["stages"] in cm.TC_DECODE_STAGES
            assert plan["stages"] <= max(2, per + 1)
            resident = min(2, -(-mn * splits // sms))
            assert resident * plan["smem"] <= SM_SMEM


def test_int8_tc_plan_invariants():
    """K6's plan by K7's rules: splits never empty, decode rings deeper only
    where a split's tiles need them, every block's shared memory (twice K7's
    weight bytes a decode stage, none for scales) within an SM's 227 KB
    with the blocks an SM holds, and a pure function of its inputs."""
    for M, N, K, sms in itertools.product(
            (1, 5, 16, 17, 64, 200, 1024), (30, 256, 2048, 11008, 128256),
            (32, 96, 200, 2048, 4096, 11008, 14336), SMS):
        plan = cm.int8_tc_plan(M, N, K, sms)
        assert plan == cm.int8_tc_plan(M, N, K, sms)
        kind, splits = plan["kind"], plan["splits"]
        assert kind == (0 if M <= cm.TC_DECODE_M else 1)
        tiles = -(-K // cm.TC_TILE_K)
        per = -(-tiles // splits)
        assert 1 <= splits <= cm.MAX_SPLITS and (splits - 1) * per < tiles  # none empty
        if tiles >= 2 * cm.TC_MIN_TILES_PER_SPLIT:
            assert per >= cm.TC_MIN_TILES_PER_SPLIT
        bm, bn = ((cm.TC_DECODE_M, cm.TC_DECODE_N) if kind == 0
                  else (cm.TC_PREFILL_M, cm.TC_PREFILL_N))
        mn = -(-M // bm) * -(-N // bn)
        assert mn * splits <= max((2 if kind == 0 else 1) * sms, mn)
        assert plan["smem"] + 1024 <= SM_SMEM
        if kind == 0:
            assert plan["stages"] in cm.TC_DECODE_STAGES
            assert plan["stages"] <= max(2, per + 1)
            assert plan["smem"] == cm.tc8_decode_smem(plan["stages"])
            resident = min(2, -(-mn * splits // sms))
            assert resident * plan["smem"] <= SM_SMEM
        else:
            assert plan["smem"] == cm.tc8_prefill_smem()


def test_tensor_core_wrappers_count_their_routes():
    """The two-route wrappers carry a counter per route beside launches."""
    for fn in (ca.paged_decode_attention_cuda, ca.flash_prefill_attention_cuda,
               ca.paged_prefill_attention_cuda, ca.paged_decode_attention_v3_cuda,
               ca.paged_decode_attention_v2_cuda, cm.int8_matmul_cuda, cm.int4_matmul_cuda):
        assert isinstance(fn.tensor_core_launches, int) and isinstance(fn.exact_launches, int)
