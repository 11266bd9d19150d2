"""Port sampler against the JAX sampler on the same noise, the port's
threefry noise against JAX's, plus the device-side stopping helpers of
the port's engine.

The port takes the noise as an argument, so the test hands it JAX's noise
and the sampled tokens must be identical in greedy, stochastic and
filtered modes. The noise itself (``step_gumbel``: threefry ``fold_in``,
random bits, uniform, Gumbel) is held against ``jax.random``: key data,
step keys, bits and uniforms exactly, the Gumbel values within 1e-6 (the
two ``log`` implementations may differ in the last place).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu.engine import sampling as jsampling
from llmq_tpu_torch.engine import sampling as tsampling
from llmq_tpu_torch.engine.engine import advance_state, suppress_stops

pytestmark = pytest.mark.unit


def _batch(seed, S=6, V=97):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 1.0, 1.3, 0.5, 2.0][:S], np.float32)
    topk = np.asarray([0, 0, 5, 0, 1, 20][:S], np.int32)
    topp = np.asarray([1.0, 1.0, 1.0, 0.9, 1.0, 0.5][:S], np.float32)
    keys = np.stack([np.asarray(jsampling.make_base_key(s, 0)) for s in range(S)])
    steps = np.arange(S, dtype=np.int32) * 3
    return logits, temps, topk, topp, keys, steps


@pytest.mark.parametrize("mode", ["greedy", "stochastic", "filtered"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_matches_jax_on_jax_noise(mode, seed):
    logits, temps, topk, topp, keys, steps = _batch(seed)
    S, V = logits.shape
    if mode == "stochastic":
        topk[:] = 0
        topp[:] = 1.0
    gumbel = np.array(jsampling._step_gumbel(jnp.asarray(keys), jnp.asarray(steps), (S, V)))
    expect = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(steps), jnp.asarray(temps),
        jnp.asarray(topk), jnp.asarray(topp), mode=mode,
    ))
    got = tsampling.sample_tokens(
        torch.from_numpy(logits), None if mode == "greedy" else torch.from_numpy(gumbel),
        torch.from_numpy(temps), torch.from_numpy(topk), torch.from_numpy(topp), mode=mode,
    ).numpy()
    np.testing.assert_array_equal(got, expect)


def test_modes_and_sampling_params_match_jax():
    for kw in ({"temperature": 0.0}, {"temperature": 0.5}, {"top_k": 3}, {"top_p": 0.8}):
        assert tsampling.required_mode(tsampling.SamplingParams(**kw)) == jsampling.required_mode(
            jsampling.SamplingParams(**kw))
    assert tsampling.join_modes(["greedy", "filtered", "stochastic"]) == "filtered"
    assert tsampling.join_modes([]) == "greedy"
    extras = {"temperature": 0.2, "top_k": 4, "stop": "END", "stop_token_ids": [5, 6],
              "seed": 9, "max_tokens": 12, "min_tokens": 2, "ignore_eos": True}
    assert vars(tsampling.SamplingParams.from_job_extras(extras, default_max_tokens=7)) == vars(
        jsampling.SamplingParams.from_job_extras(extras, default_max_tokens=7))
    assert tsampling.request_tag("job-1") == jsampling.request_tag("job-1")


def test_step_gumbel_is_a_pure_function_of_key_step_and_index():
    keys = torch.tensor([[0, 5], [0, 5], [0, 7], [3, 2**32 - 1]], dtype=torch.int64)
    steps = torch.tensor([0, 1, 0, 3], dtype=torch.int32)
    g = tsampling.step_gumbel(keys, steps, 4096)
    assert g.shape == (4, 4096) and g.dtype == torch.float32
    assert torch.isfinite(g).all()
    torch.testing.assert_close(g, tsampling.step_gumbel(keys, steps, 4096), rtol=0, atol=0)
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    # A slot's noise does not depend on which other slots share the batch.
    torch.testing.assert_close(g[2:3], tsampling.step_gumbel(keys[2:3], steps[2:3], 4096))
    # Gumbel(0, 1): mean ~ Euler-Mascheroni, variance ~ pi^2 / 6.
    assert abs(g.mean().item() - 0.5772) < 0.05
    assert abs(g.var().item() - 1.6449) < 0.15


SEEDS = [0, 7, 2**31 - 1, 2**31 + 5, 2**32 - 1, -1, -(2**31) - 1, 123456789012, None]


def test_threefry_keys_fold_in_and_bits_match_jax():
    tags = [0, jsampling.request_tag("job-1"), 0xFFFFFFFF]  # unseeded: 0x5EED ^ tag
    for seed in SEEDS:
        for tag in tags:
            expect = np.asarray(jsampling.make_base_key(seed, tag))
            got = tsampling.make_base_key(seed, tag)
            assert got.dtype == np.uint32 and (got == expect).all(), (seed, tag)
    keys = np.stack([np.asarray(jsampling.make_base_key(s, 99)) for s in SEEDS])
    steps = np.arange(len(SEEDS), dtype=np.int32) * 1000 + [0, 1, 2, 3, 4, 5, 6, 7, 2**20]
    jkeys = np.asarray(jax.random.key_data(
        jsampling.fold_step_keys(jnp.asarray(keys), jnp.asarray(steps))))
    tkeys = tsampling.fold_step_keys(torch.from_numpy(keys.astype(np.int64)),
                                     torch.from_numpy(steps))
    np.testing.assert_array_equal(tkeys.numpy(), jkeys.astype(np.int64))
    n = 1000
    jbits = np.stack([
        np.asarray(jax.random.bits(jax.random.wrap_key_data(jnp.asarray(k)), (n,), jnp.uint32))
        for k in jkeys
    ])
    np.testing.assert_array_equal(tsampling.uniform_bits(tkeys, n).numpy(),
                                  jbits.astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    juni = np.stack([
        np.asarray(jax.random.uniform(jax.random.wrap_key_data(jnp.asarray(k)), (n,),
                                      jnp.float32, minval=tiny, maxval=1.0))
        for k in jkeys
    ])
    np.testing.assert_array_equal(tsampling.uniform(tkeys, n).numpy(), juni)


def test_step_gumbel_and_sampled_tokens_match_jax():
    """The port's own noise: Gumbel within 1e-6 of JAX's, and the tokens
    that ``sample_tokens`` draws from it identical to JAX's."""
    for seed in (0, 1):
        logits, temps, topk, topp, keys, steps = _batch(seed, V=4099)
        S, V = logits.shape
        jg = np.asarray(jsampling._step_gumbel(jnp.asarray(keys), jnp.asarray(steps), (S, V)))
        tg = tsampling.step_gumbel(torch.from_numpy(keys.astype(np.int64)),
                                   torch.from_numpy(steps), V)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6)
        for mode in ("stochastic", "filtered"):
            expect = np.asarray(jsampling.sample_tokens(
                jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(steps), jnp.asarray(temps),
                jnp.asarray(topk), jnp.asarray(topp), mode=mode))
            got = tsampling.sample_tokens(
                torch.from_numpy(logits), tg, torch.from_numpy(temps), torch.from_numpy(topk),
                torch.from_numpy(topp), mode=mode).numpy()
            np.testing.assert_array_equal(got, expect)


def test_suppress_stops_masks_only_rows_under_min_tokens():
    logits = torch.zeros((3, 10))
    stop_ids = torch.tensor([[2, 7, -1], [2, -1, -1], [9, -1, -1]], dtype=torch.int32)
    steps = torch.tensor([0, 5, 1], dtype=torch.int32)
    mins = torch.tensor([3, 2, 2], dtype=torch.int32)
    out = suppress_stops(logits, stop_ids, steps, mins)
    expect = torch.zeros((3, 10))
    expect[0, 2] = expect[0, 7] = tsampling.NEG_INF  # step 0 < min 3
    expect[2, 9] = tsampling.NEG_INF  # step 1 < min 2; row 1 is past its min
    torch.testing.assert_close(out, expect, rtol=0, atol=0)


def test_advance_state_counts_steps_and_stops_on_device():
    S = 4
    tokens = torch.tensor([1, 1, 1, 1], dtype=torch.int32)
    ctx = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    bt = torch.zeros((S, 2), dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    keys = torch.zeros(S, dtype=torch.int64)
    steps = torch.tensor([0, 3, 1, 0], dtype=torch.int32)
    f = torch.zeros(S)
    limits = torch.tensor([10, 4, 10, 10], dtype=torch.int32)
    mins = torch.tensor([0, 0, 5, 0], dtype=torch.int32)
    stop_ids = torch.tensor([[9, -1], [-1, -1], [9, -1], [9, -1]], dtype=torch.int32)
    st = (tokens, ctx, bt, active, keys, steps, f, steps, f, limits, mins, stop_ids)
    out = torch.tensor([9, 4, 9, 9], dtype=torch.int32)
    new = advance_state(st, out, active)
    torch.testing.assert_close(new[0], torch.tensor([9, 4, 9, 1], dtype=torch.int32))
    torch.testing.assert_close(new[1], torch.tensor([6, 7, 8, 8], dtype=torch.int32))
    torch.testing.assert_close(new[5], torch.tensor([1, 4, 2, 0], dtype=torch.int32))
    # row 0 hit stop id 9; row 1 hit its limit; row 2's stop is under
    # min_tokens; row 3 was inactive.
    assert new[3].tolist() == [False, False, True, False]


def test_jax_gumbel_draws_are_what_the_test_feeds():
    """Guards the test's premise: JAX's sampler consumes exactly
    ``_step_gumbel``'s noise (the stochastic token is its argmax)."""
    logits, temps, _, _, keys, steps = _batch(3)
    S, V = logits.shape
    g = np.asarray(jsampling._step_gumbel(jnp.asarray(keys), jnp.asarray(steps), (S, V)))
    scaled = logits / np.maximum(temps, 1e-6)[:, None]
    expect = np.where(temps <= 0, logits.argmax(-1), (scaled + g).argmax(-1))
    got = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(steps), jnp.asarray(temps),
        jnp.zeros(S, jnp.int32), jnp.ones(S, jnp.float32), mode="stochastic"))
    np.testing.assert_array_equal(got, expect)
    assert jax.default_backend() == "cpu"
