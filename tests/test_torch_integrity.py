"""The fault planes' pure parts (M12) against the JAX package, on the same
seeded numpy inputs, exactly unless a tolerance is stated:

- ``core/faults.py::classify_failure`` on the reference's exception list
  gives the same class; the card's CUDA errors (the port's launch check,
  torch's ``CUDA error: ...``, ``torch.AcceleratorError``) classify as
  ``xla_runtime_error`` and torch's out-of-memory as ``hbm_oom`` (ROADMAP.md
  queue 3: the CUDA-error class).
- ``engine/watchdog.py``: ``dispatch_deadline_s`` and a
  ``DispatchWatchdog`` bracket's semantics (a trip raises
  ``HungDispatchError`` on exit, an exception in flight wins, a clean exit
  resets ``last_ok_age_s``, ``wedged_kind`` while overdue).
- ``ops/dispatch.py::logit_guard_stats`` on logits with NaN, +-inf, a large
  row, a low-entropy row and a masked row, thresholds on and off: ``bad``
  equal, ``stats`` within 1e-6 relative.
- ``engine/integrity.py``: ``digest_params`` of a bridged f32, bf16, int8
  and int4 tree (names and values; the port folding in small chunks),
  also over an engine's own tree (``EngineCore.params``); ``diff_digests``,
  ``page_digests`` and ``token_fold``.
- ``broker/chaos.py``: the injectors' seeded ``after`` draws, and the leaf
  a ``BitFlipInjector`` picks on the same tree.

The load ledger is held against the JAX loader's in
``tests/test_torch_weights.py``.
"""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu.broker import chaos as jchaos
from llmq_tpu.core import faults as jfaults
from llmq_tpu.engine import integrity as jint
from llmq_tpu.engine import watchdog as jwd
from llmq_tpu.models import quant as jq
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.ops import dispatch as jdispatch
from llmq_tpu_torch.broker import chaos as tchaos
from llmq_tpu_torch.core import faults as tfaults
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine import integrity as tint
from llmq_tpu_torch.engine import watchdog as twd
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.ops import dispatch as tdispatch

from test_torch_model import BASE, numpy_params

pytestmark = pytest.mark.unit


def _named(name: str):
    """An exception class called ``name`` (jaxlib's types, by name only)."""
    return type(name, (RuntimeError,), {})


REFERENCE_TEXTS = [
    ("RuntimeError", "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 2.0G"),
    ("RuntimeError", "out of memory allocating device buffer"),
    ("XlaRuntimeError", "INTERNAL: Failed to execute XLA Runtime executable"),
    ("JaxRuntimeError", "UNKNOWN: TPU halted"),
    ("RuntimeError", "xla backend error: device unreachable"),
    ("ValueError", "mesh axis 'tp' has size 2 but 4 devices"),
    ("RuntimeError", "device topology changed under the engine"),
    ("RuntimeError", "bad slice_config"),
    ("ValueError", "bad sampling parameters"),
    ("KeyError", "no such request"),
]


@pytest.mark.parametrize("type_name,text", REFERENCE_TEXTS)
def test_classify_failure_matches_the_reference_on_texts(type_name, text):
    cls = {"RuntimeError": RuntimeError, "ValueError": ValueError,
           "KeyError": KeyError}.get(type_name) or _named(type_name)
    assert tfaults.classify_failure(cls(text)) == jfaults.classify_failure(cls(text))


def test_classify_failure_matches_the_reference_on_typed_faults_and_maps_cuda_errors():
    for pkg in (jfaults, tfaults):
        got = [pkg.classify_failure(e) for e in (
            pkg.HungDispatchError("decode_block", 3.0, 1.0),
            pkg.LogitGuardError("nonfinite", "rows=1", suspects=("a",), kind="decode"),
            pkg.DeviceFaultError("mesh_error", "x"))]
        assert got == ["hung_dispatch", "numerical_fault", "mesh_error"]
    assert tfaults.DEVICE_FAULT_REASONS == jfaults.DEVICE_FAULT_REASONS
    err = tfaults.LogitGuardError("nonfinite", "rows=1", suspects=["a"], kind="decode")
    ref = jfaults.LogitGuardError("nonfinite", "rows=1", suspects=["a"], kind="decode")
    assert (str(err), err.suspects) == (str(ref), ref.suspects)
    assert str(tfaults.HungDispatchError("verify", 2.5, 1.0)) == str(
        jfaults.HungDispatchError("verify", 2.5, 1.0))
    # The card's device-runtime errors (the departure): the port's own
    # launch check, torch's text, its AcceleratorError type, cuBLAS; and
    # torch's out-of-memory on the reference's "out of memory" match.
    for exc in (RuntimeError("paged_decode kernel launch failed: CUDA error 700 (an illegal "
                             "memory access was encountered)"),
                RuntimeError("CUDA error: an illegal memory access was encountered"),
                _named("AcceleratorError")("unspecified launch failure"),
                RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx")):
        assert tfaults.classify_failure(exc) == "xla_runtime_error", exc
        assert jfaults.classify_failure(exc) is None  # the reference knows no CUDA
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert tfaults.classify_failure(oom) == jfaults.classify_failure(oom) == "hbm_oom"


def test_dispatch_deadline_and_the_watchdog_bracket_match_the_reference():
    for p99 in (None, 0.0, 0.01, 0.4, 2.0):
        for mult, min_s in ((2.0, 0.5), (5.0, 30.0), (1.0, 0.1)):
            assert twd.dispatch_deadline_s(p99, mult, min_s) == \
                jwd.dispatch_deadline_s(p99, mult, min_s)
    for wd_mod, err in ((jwd, jfaults.HungDispatchError), (twd, tfaults.HungDispatchError)):
        trips = []
        wd = wd_mod.DispatchWatchdog(mult=2.0, min_s=0.15, percentile_fn=lambda k: (
            0.2 if k == "slow" else None), on_trip=lambda *a: trips.append(a), poll_s=0.01)
        try:
            assert (wd.deadline_for("slow"), wd.deadline_for("fresh")) == (0.4, 0.15)
            with wd.guard("fresh"):
                pass
            assert wd.last_ok_age_s() < 0.1 and wd.trips == 0
            seen = []
            with pytest.raises(err) as info:
                with wd.guard("fresh"):
                    t_end = time.monotonic() + 0.5
                    while time.monotonic() < t_end:
                        seen.append(wd.wedged_kind())
                        time.sleep(0.02)
            assert (info.value.kind, info.value.deadline) == ("fresh", 0.15)
            assert "fresh" in seen and seen[0] is None and wd.trips == 1
            assert [t[0] for t in trips] == ["fresh"] and wd.wedged_kind() is None
            assert wd.last_ok_age_s() >= 0.5  # the overdue call did not count as ok
            with pytest.raises(KeyError):  # an exception in flight wins over the trip
                with wd.guard("fresh"):
                    time.sleep(0.3)
                    raise KeyError("the call's own failure")
            assert wd.trips == 2
        finally:
            wd.stop()
        assert not any(t.name == "llmq-watchdog" and t.is_alive() and t is wd._thread
                       for t in threading.enumerate())


def _guard_logits(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((8, 50)).astype(np.float32) * 3
    z[1, 7] = np.nan
    z[2, 3] = np.inf
    z[3, 9] = -np.inf
    z[4, 11] = 900.0  # large
    z[5] = -50.0
    z[5, 2] = 40.0  # low entropy
    z[6, 0] = np.nan  # masked out below
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    return z, mask


@pytest.mark.parametrize("max_abs,min_entropy", [(0.0, 0.0), (100.0, 0.5)])
def test_logit_guard_stats_match_the_reference(max_abs, min_entropy):
    z, mask = _guard_logits(3)
    j_guard = jax.jit(jdispatch.logit_guard_stats, static_argnames=("max_abs", "min_entropy"))
    j_stats, j_bad = j_guard(jnp.asarray(z), jnp.asarray(mask), max_abs=max_abs,
                             min_entropy=min_entropy)
    t_stats, t_bad = tdispatch.logit_guard_stats(torch.from_numpy(z), torch.from_numpy(mask),
                                                 max_abs=max_abs, min_entropy=min_entropy)
    np.testing.assert_array_equal(t_bad.numpy(), np.asarray(j_bad))
    np.testing.assert_allclose(t_stats.numpy(), np.asarray(j_stats), rtol=1e-6)
    assert t_bad.numpy().tolist()[1:7] == [True, True, True, max_abs > 0, min_entropy > 0, False]
    # bf16 logits and a row set with nothing wrong
    clean = z[[0, 7]].astype(jnp.bfloat16)
    m2 = np.ones(2, bool)
    j2 = j_guard(jnp.asarray(clean), jnp.asarray(m2), max_abs=max_abs, min_entropy=min_entropy)
    t2 = tdispatch.logit_guard_stats(
        params_from_numpy({"z": clean})["z"], torch.from_numpy(m2), max_abs=max_abs,
        min_entropy=min_entropy)
    np.testing.assert_array_equal(t2[1].numpy(), np.asarray(j2[1]))
    np.testing.assert_array_equal(t2[0].numpy()[:2], np.asarray(j2[0])[:2])
    # The entropy of a peaked row is a difference of terms ~30x its size:
    # f32 reductions in another order leave ~3e-6 of it, not 1e-6 relative.
    np.testing.assert_allclose(t2[0].numpy()[2], np.asarray(j2[0])[2], rtol=0, atol=1e-5)


def _jtree(dtype: str) -> dict:
    """A tiny qwen2 tree of the JAX layout, as numpy: f32, bf16, or int8 /
    int4 weight-only (JAX's ``quantize_params``, jitted)."""
    cfg = JConfig.tiny(**BASE, model_type="qwen2", attention_bias=True)
    tree = numpy_params(cfg, seed=5, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    if dtype in ("int8", "int4"):
        tree = jax.tree.map(np.asarray, jq.quantize_params(
            jax.tree.map(jnp.asarray, tree), bits=8 if dtype == "int8" else 4))
    return tree


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "int4"])
def test_digest_params_matches_the_reference_leaf_for_leaf(dtype, monkeypatch):
    tree = _jtree(dtype)
    want = jint.digest_params(jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(tint, "FOLD_CHUNK", 1000)  # chunks must compose
    bridged = params_from_numpy(tree)
    assert tint.digest_params(bridged) == want
    # The engine's own tree: the same names over the model's tensors.
    core = tengine.EngineCore(TConfig.tiny(**BASE, model_type="qwen2", attention_bias=True),
                              bridged, ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(max_num_seqs=2,
                                                                 max_model_len=64))
    assert tint.digest_params(core.params) == want
    # One flipped byte: exactly its leaf changes, in both packages.
    name = "['layers']['o_proj']" if dtype in ("f32", "bf16") else "['layers']['o_proj']['q']"
    leaf = core.params["layers"]["o_proj"]
    leaf = leaf["q"] if isinstance(leaf, dict) else leaf
    with torch.no_grad():
        leaf.view(-1)[3:4].view(torch.uint8)[0] ^= 0x10
    after = tint.digest_params(core.params)
    assert tint.diff_digests(want, after) == jint.diff_digests(want, after) == [name]
    assert tint.diff_digests(want, {k: v for k, v in want.items() if k != name}) == [name]


def test_page_digests_and_token_fold_match_the_reference():
    rng = np.random.default_rng(9)
    for pages in (rng.standard_normal((3, 2, 4, 2, 8)).astype(np.float32),
                  rng.integers(0, 2**16, (5, 4, 2, 8), dtype=np.uint16)):
        assert tint.page_digests(pages) == jint.page_digests(pages)
    assert tint.page_digests(pages)[1] != tint.page_digests(pages[::-1].copy())[1]
    for ids in ([], [0], [1, 2, 3], list(rng.integers(-5, 150_000, 40))):
        assert tint.token_fold(ids) == jint.token_fold(ids)
    assert tint.DIGEST_SIZE == jint.DIGEST_SIZE


@pytest.mark.parametrize("seed,after_range", [(0, (1, 5)), (7, (2, 4)), (43, (1, 2)),
                                              (1234, (3, 30))])
def test_injector_draws_match_the_reference(seed, after_range):
    assert tchaos.PHASE_KINDS == jchaos.PHASE_KINDS
    assert tchaos.FAULT_MODES == jchaos.FAULT_MODES
    assert tchaos.BITFLIP_TARGETS == jchaos.BITFLIP_TARGETS
    pairs = [
        (tchaos.WorkerKillSwitch("decode", lambda: None, seed=seed, after_range=after_range),
         jchaos.WorkerKillSwitch("decode", lambda: None, seed=seed, after_range=after_range)),
        (tchaos.DeviceFaultInjector("prefill", "oom", seed=seed, after_range=after_range),
         jchaos.DeviceFaultInjector("prefill", "oom", seed=seed, after_range=after_range)),
        (tchaos.BitFlipInjector("weight", seed=seed, after_range=after_range),
         jchaos.BitFlipInjector("weight", seed=seed, after_range=after_range)),
    ]
    for ours, theirs in pairs:
        assert ours.after == theirs.after
    # The leaf each picks on the same tree (the rng after the draw).
    tree = _jtree("f32")
    tflip = tchaos.BitFlipInjector("weight", mode="flip", seed=seed, after_range=after_range)
    jflip = jchaos.BitFlipInjector("weight", mode="flip", seed=seed, after_range=after_range)
    tflip.bind(SimpleNamespace(params=params_from_numpy(tree)))._corrupt_param()
    jflip.bind(SimpleNamespace(params=jax.tree.map(jnp.asarray, tree)))._corrupt_param()
    assert tflip.corrupted == jflip.corrupted


def test_injectors_fire_as_the_reference_and_corrupt_in_place():
    """A DeviceFaultInjector fires once, on the after-th dispatch of its
    phase, raising what classifies as the reference's does; a bit flip
    writes into the tensor the engine holds (a captured graph reads it)."""
    for mode, reason in (("xla_error", "xla_runtime_error"), ("oom", "hbm_oom")):
        inj = tchaos.DeviceFaultInjector("decode", mode, seed=7, after_range=(2, 4))
        ref = jchaos.DeviceFaultInjector("decode", mode, seed=7, after_range=(2, 4))
        inj("prefill")
        for _ in range(inj.after - 1):
            inj("decode_block")
        with pytest.raises(RuntimeError) as info:
            inj("decode_block")
        with pytest.raises(RuntimeError) as ref_info:
            for _ in range(ref.after):
                ref("decode_block")
        assert tfaults.classify_failure(info.value) == reason == \
            jfaults.classify_failure(ref_info.value)
        inj("decode_block")  # once only
    tree = params_from_numpy(_jtree("int8"))
    core = SimpleNamespace(params=tree, k_pages=torch.zeros(2, 3, 4, 2, 8))
    flip = tchaos.BitFlipInjector("logit", mode="nan", seed=1, after_range=(1, 1)).bind(core)
    before = tree["lm_head"]["q"].clone()
    flip("decode_block")
    assert flip.corrupted == ["['lm_head']['q']"] and core.on_dispatch is flip
    assert int(tree["lm_head"]["q"][0, 0]) == int(before[0, 0]) ^ 0x55
    kv = tchaos.BitFlipInjector("kv", seed=2, after_range=(1, 1), page=2).bind(core)
    pool = core.k_pages
    kv("prefill")
    assert core.k_pages is pool and torch.isnan(pool[:, 2]).all() and not pool[:, 1].any()
