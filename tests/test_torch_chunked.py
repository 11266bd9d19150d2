"""Port of the chunked-prefill / prefix-cache slice against the JAX package:
the plain versions of K3 (chunked prefill), K5 (v2 decode) and K4 (fused
KV-write decode) against the JAX reference ops and the Pallas kernels in
interpret mode, ``Transformer.prefill_chunk`` against JAX, the decode
kernel plan, and the prefix-cache page digests.

Inputs are made with numpy from a seed and handed to both sides, at the
case grids of ``tests/test_pallas_attention.py``. f32 attention is held
at 2e-5, logits at 1e-4; pools written by the fused-write decode must be
bit-exact on every page but the scratch page 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.models.transformer import Transformer as JTransformer
from llmq_tpu.models.transformer import make_kv_pages as jpages
from llmq_tpu.ops import attention as jref
from llmq_tpu.ops import pallas_attention as pk
from llmq_tpu.ops.dispatch import _WINDOW_DISABLED
from llmq_tpu.utils import hashing as jhashing
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.models.transformer import Transformer, init_params, make_kv_pages
from llmq_tpu_torch.ops import attention as tops
from llmq_tpu_torch.ops import dispatch as tdispatch
from llmq_tpu_torch.utils import hashing as thashing

from test_torch_model import BASE, FAMILIES, _jax_tree

pytestmark = pytest.mark.unit

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pools(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * 0.3).astype(np.float32) for _ in "kv")


def _win(window):
    return jnp.asarray([window or _WINDOW_DISABLED], jnp.int32)


# --- K3's plain version -------------------------------------------------------


def _chunk_positions(starts, valids, C):
    positions = np.full((len(starts), C), -1, np.int32)
    for r, (s, n) in enumerate(zip(starts, valids)):
        positions[r, :n] = np.arange(s, s + n)
    return positions


@pytest.mark.parametrize(
    "n_heads,n_kv,window,softcap,block_q,layer",
    [(6, 3, 7, 20.0, 4, 2)],  # window + softcap, odd group, last layer
)
def test_paged_prefill_matches_jax_and_pallas(n_heads, n_kv, window, softcap, block_q, layer):
    """A mid-prompt chunk per row (starts not page-aligned, a ragged tail
    and a row with no valid query) against the pages of earlier chunks, at
    one layer of a stacked pool; the dispatch's CPU route is the plain
    version itself."""
    S, d, page, pps, C, L = 4, 16, 8, 4, 10, 3
    rng = np.random.default_rng(n_heads * 10 + n_kv)
    q = (rng.standard_normal((S, C, n_heads, d)) * 0.3).astype(np.float32)
    kp, vp = _pools(n_heads, (L, 1 + S * pps, page, n_kv, d))
    bt = np.arange(1, 1 + S * pps, dtype=np.int32).reshape(S, pps)
    starts, valids = [0, 5, 17, 0], [10, 10, 7, 0]
    positions = _chunk_positions(starts, valids, C)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap)
    ours = tops.paged_prefill_attention(*_t(q, kp, vp, bt, positions), layer=layer, **kw)
    ref = jref.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(positions), layer=jnp.asarray(layer, jnp.int32), **kw,
    )
    np.testing.assert_allclose(ours.numpy(), _np(ref), **TOL)
    pallas = pk.paged_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(starts, jnp.int32), jnp.asarray(valids, jnp.int32), _win(window),
        jnp.asarray(layer, jnp.int32), scale=d**-0.5, softcap=softcap, block_q=block_q,
        interpret=True,
    )
    for r, n in enumerate(valids):  # rows past num_valid are padding
        np.testing.assert_allclose(ours[r, :n].numpy(), _np(pallas)[r, :n], **TOL)
    assert torch.isfinite(ours).all()
    routed = tdispatch.chunked_prefill_attention(*_t(q, kp, vp, bt, positions), layer=layer,
                                                 **kw)
    torch.testing.assert_close(routed, ours, rtol=0, atol=0)


# --- K5's and K4's plain versions ---------------------------------------------


def _decode_case(seed, *, S, n_heads, n_kv, d, page, pps, L):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((S, n_heads, d)) * 0.3).astype(np.float32)
    kp, vp = _pools(seed + 1, (L, 1 + S * pps, page, n_kv, d))
    bt = np.arange(1, 1 + S * pps, dtype=np.int32).reshape(S, pps)
    return q, kp, vp, bt


@pytest.mark.parametrize(
    "pages_per_chunk,ctx,window",
    [
        (1, [3, 8, 27, 40], None),  # 5 pages per row: chunk padding at 3
        (3, [3, 9, 27, 0], 10),  # and an inactive row, a window
    ],
)
def test_plain_decode_matches_pallas_v2(pages_per_chunk, ctx, window):
    S, n_heads, n_kv, d, page, L = 4, 8, 2, 16, 8, 2
    pps = max(-(-max(ctx) // page), 5)
    q, kp, vp, bt = _decode_case(pages_per_chunk, S=S, n_heads=n_heads, n_kv=n_kv, d=d,
                                 page=page, pps=pps, L=L)
    cl = np.asarray(ctx, np.int32)
    ours = tops.paged_decode_attention(*_t(q, kp, vp, bt, cl), scale=d**-0.5, layer=1,
                                       sliding_window=window).numpy()
    v2 = pk.paged_decode_attention_pallas_v2(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(cl),
        _win(window), jnp.asarray(1, jnp.int32), scale=d**-0.5,
        pages_per_chunk=pages_per_chunk, interpret=True,
    )
    live = cl > 0  # ctx == 0: the kernels write zeros, the plain version an average
    np.testing.assert_allclose(ours[live], _np(v2)[live], **TOL)
    assert (_np(v2)[~live] == 0).all()


@pytest.mark.parametrize(
    "n_heads,n_kv,window,softcap,chunk",
    [(6, 3, 7, 20.0, 3)],  # window + softcap, padded pages_per_seq
)
def test_fused_write_decode_matches_pallas_v3(n_heads, n_kv, window, softcap, chunk):
    """Write-then-attend in one call: the output against the v3 kernel, the
    pools bit-exact with its pools on pages >= 1 (an inactive ctx == 0 row
    writes nothing on any page but scratch)."""
    S, d, page, pps, L, layer = 5, 16, 8, 5, 3, 1
    q, kp, vp, bt = _decode_case(20 + n_heads, S=S, n_heads=n_heads, n_kv=n_kv, d=d,
                                 page=page, pps=pps, L=L)
    rng = np.random.default_rng(23)
    k_new = (rng.standard_normal((S, n_kv, d)) * 0.3).astype(np.float32)
    v_new = (rng.standard_normal((S, n_kv, d)) * 0.3).astype(np.float32)
    cl = np.asarray([1, 7, 8, 23, 0], np.int32)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap)
    tk, tv = _t(kp, vp)
    out, k_out, v_out = tdispatch.decode_attention_fused_write(
        *_t(q), tk, tv, *_t(k_new, v_new, bt, cl), layer=layer, **kw
    )
    assert k_out is tk and v_out is tv  # in place
    o3, k3, v3 = pk.paged_decode_attention_pallas_v3(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(bt), jnp.asarray(cl), _win(window),
        jnp.asarray(layer, jnp.int32), scale=d**-0.5, softcap=softcap,
        pages_per_chunk=chunk, interpret=True,
    )
    live = cl > 0
    np.testing.assert_allclose(out.numpy()[live], _np(o3)[live], **TOL)
    np.testing.assert_array_equal(tk.numpy()[:, 1:], _np(k3)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], _np(v3)[:, 1:])


# --- the model's chunked forward and the decode plan --------------------------


@pytest.mark.parametrize("family", ["gemma2"])
def test_prefill_chunk_matches_jax(family):
    """Two chunks through the model: the first from position 0, the second
    continuing mid-page with a ragged tail and a padding row. Logits at
    each row's last valid position within 1e-4 (f32), pools within 1e-5."""
    kw = {**BASE, **FAMILIES[family]}
    jcfg, tcfg = JConfig.tiny(**kw), TConfig.tiny(**kw)
    tree = _jax_tree(jcfg, seed=3)
    model = Transformer(tcfg, params_from_numpy(tree))
    jm = JTransformer(jcfg, attn_backend="xla")
    jparams = jax.tree.map(jnp.asarray, tree)
    B, C, page, P = 3, 12, 8, 16
    rng = np.random.default_rng(11)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    jk, jv = jpages(jcfg, P, page, jnp.float32)
    tk, tv = make_kv_pages(tcfg, P, page, torch.float32)
    for starts, valids in (([0, 0, 0], [12, 12, 5]), ([12, 12, 5], [12, 3, 0])):
        positions = _chunk_positions(starts, valids, C)
        tokens = rng.integers(1, kw["vocab_size"], size=(B, C)).astype(np.int32)
        last = np.maximum(np.asarray(valids) - 1, 0).astype(np.int32)
        jl, jk, jv = jm.prefill_chunk(
            jparams, jnp.asarray(tokens), jnp.asarray(positions), jk, jv, jnp.asarray(bt),
            jnp.asarray(last),
        )
        tl = model.prefill_chunk(*_t(tokens, positions), tk, tv, *_t(bt, last))
        rows = np.asarray(valids) > 0
        np.testing.assert_allclose(tl.numpy()[rows], _np(jl)[rows], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk.numpy()[:, 1:], _np(jk)[:, 1:], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv.numpy()[:, 1:], _np(jv)[:, 1:], rtol=1e-5, atol=1e-5)


def test_decode_kernel_plan_and_env(monkeypatch):
    for value, want in (("", "v1"), ("v2", "v2"), ("V3", "v3")):
        monkeypatch.setenv("LLMQ_DECODE_KERNEL", value)
        assert tdispatch.resolve_decode_kernel() == want
    monkeypatch.setenv("LLMQ_DECODE_KERNEL", "v4")
    with pytest.raises(ValueError, match="LLMQ_DECODE_KERNEL"):
        tdispatch.resolve_decode_kernel()
    with pytest.raises(ValueError, match="LLMQ_DECODE_KERNEL"):
        cfg = TConfig.tiny(**BASE)  # resolved when the model is built
        Transformer(cfg, init_params(cfg, torch.Generator().manual_seed(0)))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tdispatch.decode_kernel_plan("v3", cpu) == ("plain", False)
    assert tdispatch.decode_kernel_plan("v1", cuda) == ("v1", False)
    assert tdispatch.decode_kernel_plan("v2", cuda) == ("v2", False)
    assert tdispatch.decode_kernel_plan("v3", cuda) == ("v3", True)


def test_token_prefix_chain_bytes_match_jax():
    rng = np.random.default_rng(0)
    for n, page in ((1, 8), (8, 8), (9, 8), (100, 32), (65, 16)):
        ids = rng.integers(-5, 200_000, size=n).tolist()
        assert thashing.token_prefix_chain(ids, page) == jhashing.token_prefix_chain(ids, page)
    assert thashing.chain_hash(b"x", [1, -2, 2**40]) == jhashing.chain_hash(b"x", [1, -2, 2**40])


def test_page_allocator_matches_jax():
    """The refcounted allocator with its evictable pool: the same random
    alloc / share / free(cacheable) / drop_cached sequence gives the same
    pages, refcounts, availability and eviction order as JAX's."""
    from llmq_tpu.engine.scheduler import OutOfPages as JOut
    from llmq_tpu.engine.scheduler import PageAllocator as JAlloc
    from llmq_tpu_torch.engine.scheduler import OutOfPages as TOut
    from llmq_tpu_torch.engine.scheduler import PageAllocator as TAlloc

    rng = np.random.default_rng(0)
    allocs = (JAlloc(24), TAlloc(24))
    evicted = ([], [])
    for a, ev in zip(allocs, evicted):
        a.on_evict = ev.append
    held = []
    for _ in range(400):
        op = rng.integers(4)
        if op == 0:
            n = int(rng.integers(1, 5))
            got = []
            for a, err in zip(allocs, (JOut, TOut)):
                try:
                    got.append(a.alloc(n))
                except err:
                    got.append(None)
            assert got[0] == got[1]
            if got[0]:
                held.extend(got[0])
        elif op == 1 and held:
            page = held.pop(int(rng.integers(len(held))))
            cacheable = bool(rng.integers(2))
            for a in allocs:
                a.free([page], cacheable=cacheable)
        elif op == 2:
            live = sorted(set(held) | set(allocs[0]._cached))  # allocated or parked
            if live:
                page = live[int(rng.integers(len(live)))]
                for a in allocs:
                    a.share(page)
                held.append(page)
        elif op == 3 and allocs[0]._cached:
            page = list(allocs[0]._cached)[int(rng.integers(len(allocs[0]._cached)))]
            for a in allocs:
                a.drop_cached(page)
        assert allocs[0].available == allocs[1].available
        assert [allocs[0].refcount(p) for p in range(24)] == [allocs[1].refcount(p)
                                                              for p in range(24)]
    assert evicted[0] == evicted[1] and evicted[1]
