"""The port's checkpoint loader and HF tokenizer against the JAX package's.

``llmq_tpu_torch.engine.weights.load_checkpoint`` reads the offline
``tests/make_hf_fixture.py`` checkpoint (qwen2, 4 layers, f32, sharded
with an index) into the same tree as ``llmq_tpu.engine.weights.
load_checkpoint``, every leaf bit for bit, at f32, bf16, and with int8 /
int4 quantize-on-stream. Its own safetensors reader is held against
``safetensors.safe_open`` on F32 / F16 / BF16 tensors, sharded and
unsharded; an unknown dtype tag raises. ``HFTokenizer`` against the
reference's: encode, decode, chat-template ids, eos ids. The fixture is
built once for the module.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu_torch.engine import weights as tw
from llmq_tpu_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.unit

pytest.importorskip("transformers")
pytest.importorskip("safetensors")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from tests.make_hf_fixture import build

    return build(tmp_path_factory.mktemp("hf") / "qwen2-micro")


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


@pytest.mark.parametrize("dtype,quantize", [
    ("float32", False), ("bfloat16", False), ("bfloat16", "int8"), ("bfloat16", "int4"),
    ("float32", "int4"),
])
def test_load_checkpoint_matches_the_jax_loader(hf_dir, dtype, quantize):
    """The tree bit for bit, and the load ledger (``checksum_ledger``: a
    blake2b of each streamed buffer's device-bound bytes) name for name."""
    from llmq_tpu.engine.weights import load_checkpoint as jax_load

    ref_ledger, got_ledger = {}, {}
    ref = jax_load(hf_dir, dtype=getattr(jnp, dtype), quantize=quantize,
                   checksum_ledger=ref_ledger)
    ref = params_from_numpy(jax.tree.map(np.asarray, ref))
    got = tw.load_checkpoint(hf_dir, dtype=getattr(torch, dtype), device="cpu",
                             quantize=quantize, checksum_ledger=got_ledger)
    assert got_ledger == ref_ledger and "layers.q_proj" + (".q" if quantize else "") in got_ledger
    ref_leaves, got_leaves = dict(_leaves(ref)), dict(_leaves(got))
    assert sorted(got_leaves) == sorted(ref_leaves)
    for name, t in got_leaves.items():
        r = ref_leaves[name]
        assert (t.dtype, t.shape) == (r.dtype, r.shape), name
        assert np.array_equal(_bits(t), _bits(r)), name


def test_quantize_on_stream_keeps_the_reference_loaders_arithmetic(hf_dir):
    """The loader's int8 tree is its block quantizer applied to whole
    tensors (the embed and lm_head row chunks change nothing), and, like
    the JAX loader's, differs in some scales from ``quantize_params`` of
    the loaded tree, whose reciprocal product is XLA's (ROADMAP.md queue 3)."""
    from llmq_tpu_torch.models import quant as qm

    plain = tw.load_checkpoint(hf_dir, dtype=torch.float32, device="cpu")
    loaded = tw.load_checkpoint(hf_dir, dtype=torch.float32, device="cpu", quantize="int8")
    for key in ("q_proj", "down_proj"):
        q, s = tw._quant_int8(plain["layers"][key], axis=-2)
        assert torch.equal(loaded["layers"][key]["q"], q)
        assert torch.equal(loaded["layers"][key]["scale"], s)
    q, s = tw._quant_int8(plain["embed"], axis=1)
    assert torch.equal(loaded["embed"]["q"], q) and torch.equal(loaded["embed"]["scale"], s)
    q, s = tw._quant_int8(plain["lm_head"], axis=0)
    assert torch.equal(loaded["lm_head"]["q"], q) and torch.equal(loaded["lm_head"]["scale"], s)
    whole = qm.quantize_params(plain)
    scales = [(loaded["layers"][k]["scale"] != whole["layers"][k]["scale"]).sum().item()
              for k in ("q_proj", "gate_proj", "down_proj")]
    assert sum(scales) > 0


def test_reader_matches_safe_open(hf_dir, tmp_path):
    from safetensors import safe_open

    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.f32": torch.randn((7, 5), generator=g),
        "b.f16": torch.randn((3, 4, 6), generator=g).half(),
        "c.bf16": torch.randn((9, 16), generator=g).bfloat16(),
        "d.i8": torch.randint(-128, 127, (11,), generator=g, dtype=torch.int8),
    }
    from safetensors.torch import save_file

    save_file(tensors, str(tmp_path / "model.safetensors"))
    shards = [tmp_path / "model.safetensors"] + sorted(hf_dir.glob("*.safetensors"))
    assert len(shards) > 2  # the fixture is sharded
    for shard in shards:
        ours = tw.SafetensorsFile(shard)
        with safe_open(str(shard), framework="pt") as ref:
            assert sorted(ours.keys()) == sorted(ref.keys())
            for name in ref.keys():
                r = ref.get_tensor(name)
                t = ours.get(name)
                assert t.dtype == r.dtype and t.shape == r.shape
                assert torch.equal(t.view(torch.uint8), r.contiguous().view(torch.uint8))
                if r.dim() >= 1 and r.shape[0] > 2:
                    assert torch.equal(ours.get_rows(name, 1, 3), r[1:3])
        ours.close()
    # Unsharded and sharded layouts give the index the JAX loader builds.
    from llmq_tpu.engine.weights import _open_checkpoint

    assert tw.checkpoint_index(hf_dir) == _open_checkpoint(hf_dir)
    assert tw.checkpoint_index(tmp_path) == {k: tmp_path / "model.safetensors" for k in tensors}


def test_unknown_dtype_tag_raises(tmp_path):
    header = json.dumps({"w": {"dtype": "F4", "shape": [2], "data_offsets": [0, 1]}}).encode()
    (tmp_path / "model.safetensors").write_bytes(struct.pack("<Q", len(header)) + header + b"\0")
    with pytest.raises(ValueError, match="'F4'"):
        tw.SafetensorsFile(tmp_path / "model.safetensors")


def test_hf_tokenizer_matches_the_reference(hf_dir):
    from llmq_tpu.engine.tokenizer import HFTokenizer as RefTokenizer

    from llmq_tpu_torch.engine.tokenizer import HFTokenizer

    ours, ref = HFTokenizer(str(hf_dir)), RefTokenizer(str(hf_dir))
    assert ours.eos_token_ids == ref.eos_token_ids and ours.eos_token_ids
    texts = ["The quick brown fox jumps over the lazy dog.", "Paged attention, ünïcode ✓",
             ""]
    for text in texts:
        ids = ours.encode(text)
        assert ids == ref.encode(text)
        assert ours.decode(ids) == ref.decode(ids)
    messages = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": "Say hello."}]
    assert ours.apply_chat_template(messages) == ref.apply_chat_template(messages)
    assert ours.convert_tokens_to_ids("<|im_end|>") == ref.convert_tokens_to_ids("<|im_end|>")
