"""HF checkpoint loading: safetensors → stacked param tree, streamed.

Port of ``llmq_tpu/engine/weights.py`` (``load_checkpoint`` :243). Reads a
HuggingFace model directory (config.json + *.safetensors, sharded with
``model.safetensors.index.json`` or not), maps tensor names onto the
``models/transformer.py`` layout, stacks per-layer weights on a leading
[L, ...] axis and **streams** them onto the device:

- Each stacked parameter is allocated on the device and filled one layer
  at a time: host memory never holds more than one layer's tensor of one
  parameter.
- Large 2-D tensors (embeddings, lm_head) are read in bounded row chunks
  (``_CHUNK_BYTES`` of source and converted data).

The safetensors format is read here, with no package: an 8-byte
little-endian header length, a JSON header of ``{name: {dtype, shape,
data_offsets}}`` (plus an optional ``__metadata__``), then the raw
little-endian data. A block's bytes are read at their offset into one
reusable host buffer (page-locked for a CUDA load) and viewed in their
dtype (bf16 and fp8 travel as their bits) before the copy to the device,
so the host holds ~one block whatever the kernel does with file pages. (A
memory map with the pages dropped after each copy did not bound the
resident set as measured on the H100 host: PERF.md §6.) An unknown dtype
tag raises with its name.

Numbers follow the reference loader bit for bit: a float block is cast to
``dtype`` with round to nearest even; ``quantize="int8"`` / ``"int4"``
quantizes each block as it lands, in f32 over the stored values, with the
reference host code's arithmetic (``_np_quant`` / ``_np_quant_int4``:
true division by 127 and 15, half-to-even rounding), scales cast to
``dtype`` at the end. That is not ``models/quant.py``'s arithmetic, which
reproduces the JAX package's jitted quantizers (a multiplication by the
f32 reciprocal): the two give other codes or scales for a small share of
the elements, in the JAX package as here (ROADMAP.md queue 3). The
full-precision copy of a whole parameter never exists on the device.

Name mapping (HF → ours):
    model.embed_tokens.weight            embed                 [V, H]
    model.layers.N.input_layernorm       layers.ln1[N]
    model.layers.N.self_attn.{q,k,v}_proj  layers.{q,k,v}_proj[N]  (transposed)
    model.layers.N.self_attn.{q,k,v}_proj.bias  layers.{q,k,v}_bias[N]  (qwen2)
    model.layers.N.self_attn.{q,k}_norm  layers.{q,k}_norm[N]  (qwen3)
    model.layers.N.self_attn.o_proj      layers.o_proj[N]      (transposed)
    model.layers.N.post_attention_layernorm
        → layers.ln2[N] for llama/qwen (it is the pre-MLP norm there)
        → layers.post_attn_norm[N] for gemma2 (true post-attn norm)
    model.layers.N.pre_feedforward_layernorm   layers.ln2[N]   (gemma2)
    model.layers.N.post_feedforward_layernorm  layers.post_mlp_norm[N]
    model.layers.N.mlp.{gate,up,down}_proj     layers.*[N]     (transposed)
    model.layers.N.mlp.gate                    layers.router[N]   (MoE; transposed)
    model.layers.N.mlp.experts.E.{gate,up,down}_proj
        → layers.expert_{gate,up,down}_proj[N, E]  (transposed; streamed one
          (layer, expert) tensor at a time)
    model.layers.N.mlp.shared_expert.{gate,up,down}_proj
        → layers.shared_{gate,up,down}_proj[N]     (qwen2_moe; transposed)
    model.layers.N.mlp.shared_expert_gate      layers.shared_expert_gate[N]
    model.norm.weight                    final_norm
    lm_head.weight                       lm_head               (transposed;
                                         none for tied embeddings)

``checksum_ledger`` (the integrity plane's load ledger, JAX :156-239): a
dict the load fills with ``{stream name: blake2b-16 hex}`` over each
streamed buffer's device-bound bytes (after conversion or quantization,
block by block: ``layers.<name>``, ``layers.<name>.q``, ``embed``,
``final_norm``, ``lm_head``), equal to the JAX loader's for the same
checkpoint and dtype. Blocks are converted on the device here, so each is
copied back to the host to be hashed: a ledger costs a device-to-host
copy and a blake2b pass over the tree.

Left out of the reference's signature: ``mesh`` (sharded streaming, with
multi-GPU: ROADMAP M13).
"""

from __future__ import annotations

import hashlib
import json
import logging
import struct
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import torch

from llmq_tpu_torch.device import DeviceLike, resolve_device
from llmq_tpu_torch.models import quant as qm
from llmq_tpu_torch.models.config import ModelConfig

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

# Row-chunk budget for streaming large 2-D tensors (bytes of source data).
_CHUNK_BYTES = 256 * 2**20

#: safetensors dtype tag -> torch dtype
ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E5M2": torch.float8_e5m2, "F8_E4M3": torch.float8_e4m3fn,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_TORCH_TO_TAG = {dt: tag for tag, dt in ST_DTYPES.items()}


class SafetensorsFile:
    """One ``.safetensors`` file; tensors (or row ranges of them) come out
    as CPU tensors over a host buffer that the next read reuses (callers
    copy them), page-locked with ``pin``."""

    def __init__(self, path: Union[str, Path], pin: bool = False) -> None:
        self.path = Path(path)
        self._pin = pin
        self._file = self.path.open("rb")
        (n,) = struct.unpack("<Q", self._file.read(8))
        header = json.loads(self._file.read(n).decode("utf-8"))
        self._base = 8 + n
        self._buf = torch.empty(0, dtype=torch.uint8)
        header.pop("__metadata__", None)
        self.entries: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            tag = info["dtype"]
            if tag not in ST_DTYPES:
                raise ValueError(f"{self.path.name}: tensor {name!r} has dtype tag {tag!r}, "
                                 f"which the loader does not know (known: {sorted(ST_DTYPES)})")
            begin, end = info["data_offsets"]
            self.entries[name] = (tag, tuple(info["shape"]), begin, end)

    def keys(self):
        return self.entries.keys()

    def dtype_tag(self, name: str) -> str:
        return self.entries[name][0]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.entries[name][1]

    def _read(self, tag: str, shape, offset: int, nbytes: int) -> torch.Tensor:
        if self._buf.numel() < nbytes:
            self._buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self._pin)
        raw = self._buf[:nbytes]
        view, done = memoryview(raw.numpy()), 0
        self._file.seek(self._base + offset)
        while done < nbytes:
            got = self._file.readinto(view[done:])
            if not got:
                raise EOFError(f"{self.path.name}: {nbytes - done} bytes missing at {offset}")
            done += got
        return raw.view(ST_DTYPES[tag]).reshape(shape)

    def get(self, name: str) -> torch.Tensor:
        tag, shape, begin, end = self.entries[name]
        return self._read(tag, shape, begin, end - begin)

    def get_rows(self, name: str, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo:hi) of a tensor, without reading the rest."""
        tag, shape, begin, _ = self.entries[name]
        row = ST_DTYPES[tag].itemsize
        for n in shape[1:]:
            row *= n
        return self._read(tag, (hi - lo, *shape[1:]), begin + lo * row, (hi - lo) * row)

    def close(self) -> None:
        self._file.close()
        self._buf = torch.empty(0, dtype=torch.uint8)


def checkpoint_index(model_path: Union[str, Path]) -> Dict[str, Path]:
    """Tensor name → shard file, from ``model.safetensors.index.json`` or
    from every ``*.safetensors`` file of the directory."""
    model_path = Path(model_path)
    index_file = model_path / "model.safetensors.index.json"
    if index_file.exists():
        weight_map = json.loads(index_file.read_text())["weight_map"]
        return {name: model_path / fname for name, fname in weight_map.items()}
    shards = sorted(model_path.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"No *.safetensors under {model_path}")
    index: Dict[str, Path] = {}
    for shard in shards:
        f = SafetensorsFile(shard)
        index.update({name: shard for name in f.keys()})
        f.close()
    return index


class _TensorReader:
    """Reads tensors from the shards of a checkpoint, one open file each."""

    def __init__(self, model_path: Path, pin: bool) -> None:
        self.index = checkpoint_index(model_path)
        self._pin = pin
        self._files: Dict[Path, SafetensorsFile] = {}

    def file(self, name: str) -> SafetensorsFile:
        path = self.index[name]
        f = self._files.get(path)
        if f is None:
            f = self._files[path] = SafetensorsFile(path, pin=self._pin)
        return f

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.file(name).shape(name)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


def _quant_int8(a32: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of one f32 block, as the reference
    loader's host code (``_np_quant``): true f32 division by 127 (a
    divisor tensor, so no kernel turns it into a reciprocal product)."""
    amax = a32.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.round(a32 / scale.unsqueeze(axis)).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _quant_int4(a32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int4 group quantization of one f32 [.., K, N] block, as the
    reference loader's ``_np_quant_int4``: packed codes, f32 scale and
    zero per group of ``quant.int4_group(K)`` rows."""
    k = a32.shape[-2]
    if k % 2:
        raise ValueError(f"int4 needs an even contraction dim, got {k}")
    group = qm.int4_group(k)
    ag = a32.reshape(*a32.shape[:-2], k // group, group, a32.shape[-1])
    amin = ag.amin(dim=-2)
    amax = ag.amax(dim=-2)
    span = amax - amin
    scale = torch.where(amax > amin, span / torch.full_like(span, 15.0), torch.ones_like(span))
    zero = torch.round(-amin / scale)
    q = torch.round(ag / scale.unsqueeze(-2) + zero.unsqueeze(-2)).clamp_(0, 15)
    q = q.to(torch.uint8).reshape(a32.shape)
    return qm.pack_int4(q), scale, zero


def _host_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes in C order, as numpy's ``tobytes`` gives them."""
    t = t.detach().contiguous().reshape(-1)
    if t.dtype != torch.uint8:
        t = t.view(torch.uint8)
    return t.cpu().numpy().tobytes()


def _stream(shape, dtype, blocks: Iterable[Tuple[Any, torch.Tensor]], device,
            axis: int = 0, *, name: str = "",
            ledger: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """A device buffer of ``shape`` filled block by block: an int start
    along ``axis``, a tuple start at that index of the leading axes (the
    block keeps them as size-1 axes); with a ``ledger``, the blocks' bytes
    folded into a blake2b under ``name``."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    fold = hashlib.blake2b(digest_size=16) if ledger is not None else None
    for start, block in blocks:
        if fold is not None:
            fold.update(_host_bytes(block))
        if isinstance(start, tuple):
            buf[start].copy_(block.reshape(block.shape[len(start):]))
        else:
            buf.narrow(axis, start, block.shape[axis]).copy_(block)
    if fold is not None:
        ledger[name] = fold.hexdigest()
    return buf


def load_checkpoint(
    model_path: Union[str, Path],
    config: Optional[ModelConfig] = None,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda",
    quantize: Union[bool, str] = False,
    checksum_ledger: Optional[Dict[str, str]] = None,
) -> Params:
    """Load an HF checkpoint directory into the stacked param layout on
    ``device``, ``dtype`` the compute (and scale) dtype.

    ``quantize`` (``--dtype int8``) quantizes the big matmul weights to
    symmetric per-channel int8 *while streaming*; ``quantize="int4"`` puts
    the layer matmul weights on the group rung (packed codes, per-group
    scale and zero) while the embedding table and LM head stay int8, as
    in the reference."""
    model_path = Path(model_path)
    if config is None:
        config = ModelConfig.from_pretrained(model_path)
    dev = resolve_device(device)
    reader = _TensorReader(model_path, pin=dev.type == "cuda")
    L = config.num_layers
    quant_mode = "int4" if str(quantize).lower() == "int4" else ("int8" if quantize else None)

    def fetch(f: SafetensorsFile, name: str, rows=None) -> torch.Tensor:
        """A stored tensor (or rows of it) on the device, in its stored
        dtype, in memory of its own (the reader's buffer is reused)."""
        host = f.get(name) if rows is None else f.get_rows(name, *rows)
        out = host.to(dev)
        return out.clone() if out.data_ptr() == host.data_ptr() else out

    def stacked(our_name: str, fmt: str, *, transpose: bool = False, experts: int = 0):
        """Stream layer tensors into a [L, ...] device stack; with
        ``experts`` E, a [L, E, ...] expert stack from ``fmt``'s ``{e}``
        tensors, one (layer, expert) tensor at a time."""
        lead = (L, experts) if experts else (L,)
        index = [(i, e) for i in range(L) for e in range(experts)] if experts else [
            (i,) for i in range(L)]
        shape0 = reader.shape(fmt.format(i=0, e=0))
        if transpose:
            shape0 = shape0[::-1]
        quant = bool(quant_mode) and our_name in qm.QUANTIZED_LAYER_KEYS
        int4 = quant and quant_mode == "int4"
        if int4:
            full = (*lead, *shape0[:-2], shape0[-2] // 2, shape0[-1])
            groups = shape0[-2] // qm.int4_group(shape0[-2])
            scales = torch.empty((*lead, *shape0[:-2], groups, shape0[-1]), dtype=dtype,
                                 device=dev)
            zeros = torch.empty_like(scales)
        elif quant:
            full = (*lead, *shape0)
            scales = torch.empty((*lead, *shape0[:-2], shape0[-1]), dtype=dtype, device=dev)

        def blocks():
            for at in index:
                name = fmt.format(i=at[0], e=at[-1])
                arr = fetch(reader.file(name), name)
                if transpose:
                    arr = arr.T
                if int4:
                    arr, s, z = _quant_int4(arr.float())
                    scales[at] = s
                    zeros[at] = z
                elif quant:
                    arr, s = _quant_int8(arr.float(), axis=-2)
                    scales[at] = s
                else:
                    arr = arr.to(dtype)
                yield at, arr.reshape((1,) * len(at) + tuple(arr.shape))

        stream = f"layers.{our_name}" + (".q" if quant else "")
        if not quant:
            return _stream((*lead, *shape0), dtype, blocks(), dev, name=stream,
                           ledger=checksum_ledger)
        buf = _stream(full, torch.uint8 if int4 else torch.int8, blocks(), dev, name=stream,
                      ledger=checksum_ledger)
        if int4:
            return {"q": buf, "scale": scales, "zero": zeros}
        return {"q": buf, "scale": scales}

    def big2d(our_name: str, hf_name: str, *, transpose: bool = False):
        """Stream a large 2-D tensor in bounded row chunks."""
        f = reader.file(hf_name)
        rows, cols = f.shape(hf_name)
        # A converting load briefly holds both the stored rows and the
        # converted copy: budget the chunk by both sizes.
        stored = ST_DTYPES[f.dtype_tag(hf_name)]
        converts = f.dtype_tag(hf_name) != _TORCH_TO_TAG.get(dtype)
        itemsize = stored.itemsize + dtype.itemsize if converts else dtype.itemsize
        chunk = max(1, _CHUNK_BYTES // max(1, cols * itemsize))
        shape = (cols, rows) if transpose else (rows, cols)
        axis = 1 if transpose else 0
        # Top-level tensors stay on the int8 rung under either quantize mode.
        quant = bool(quant_mode) and our_name in qm.QUANTIZED_TOP_KEYS
        # embed quantizes per ROW (lookup axis); lm_head (streamed
        # transposed, [H, V]) per output column — both reduce over the
        # stored tensor's column axis.
        scales = torch.empty((rows,), dtype=dtype, device=dev) if quant else None

        def blocks():
            for lo in range(0, rows, chunk):
                hi = min(rows, lo + chunk)
                arr = fetch(f, hf_name, rows=(lo, hi))
                if quant:
                    arr, s = _quant_int8(arr.float(), axis=1)
                    scales[lo:hi] = s
                else:
                    arr = arr.to(dtype)
                yield lo, arr.T if transpose else arr

        buf = _stream(shape, torch.int8 if quant else dtype, blocks(), dev, axis=axis,
                      name=our_name + (".q" if quant else ""), ledger=checksum_ledger)
        return {"q": buf, "scale": scales} if quant else buf

    layers: Params = {"ln1": stacked("ln1", "model.layers.{i}.input_layernorm.weight")}
    if config.post_norms:  # gemma2 4-norm layout
        layers["post_attn_norm"] = stacked(
            "post_attn_norm", "model.layers.{i}.post_attention_layernorm.weight")
        layers["ln2"] = stacked("ln2", "model.layers.{i}.pre_feedforward_layernorm.weight")
        layers["post_mlp_norm"] = stacked(
            "post_mlp_norm", "model.layers.{i}.post_feedforward_layernorm.weight")
    else:
        layers["ln2"] = stacked("ln2", "model.layers.{i}.post_attention_layernorm.weight")
    linear = [("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
              ("v_proj", "self_attn.v_proj"), ("o_proj", "self_attn.o_proj")]
    if config.num_experts:
        linear.append(("router", "mlp.gate"))
    else:
        linear += [("gate_proj", "mlp.gate_proj"), ("up_proj", "mlp.up_proj"),
                   ("down_proj", "mlp.down_proj")]
    for ours, theirs in linear:
        layers[ours] = stacked(ours, f"model.layers.{{i}}.{theirs}.weight", transpose=True)
    if config.num_experts:
        for part in ("gate", "up", "down"):
            layers[f"expert_{part}_proj"] = stacked(
                f"expert_{part}_proj", f"model.layers.{{i}}.mlp.experts.{{e}}.{part}_proj.weight",
                transpose=True, experts=config.num_experts)
        if config.shared_expert_intermediate_size:
            for ours, theirs in (("shared_gate_proj", "shared_expert.gate_proj"),
                                 ("shared_up_proj", "shared_expert.up_proj"),
                                 ("shared_down_proj", "shared_expert.down_proj"),
                                 ("shared_expert_gate", "shared_expert_gate")):
                layers[ours] = stacked(ours, f"model.layers.{{i}}.mlp.{theirs}.weight",
                                       transpose=True)
    if config.attention_bias:
        for ours, theirs in (("q_bias", "self_attn.q_proj"), ("k_bias", "self_attn.k_proj"),
                             ("v_bias", "self_attn.v_proj")):
            layers[ours] = stacked(ours, f"model.layers.{{i}}.{theirs}.bias")
    if config.qk_norm:
        layers["q_norm"] = stacked("q_norm", "model.layers.{i}.self_attn.q_norm.weight")
        layers["k_norm"] = stacked("k_norm", "model.layers.{i}.self_attn.k_norm.weight")

    norm = reader.file("model.norm.weight")
    params: Params = {
        "embed": big2d("embed", "model.embed_tokens.weight"),
        "final_norm": _stream(norm.shape("model.norm.weight"), dtype,
                              [(0, fetch(norm, "model.norm.weight").to(dtype))], dev,
                              name="final_norm", ledger=checksum_ledger),
        "layers": layers,
    }
    if not config.tie_word_embeddings and "lm_head.weight" in reader.index:
        params["lm_head"] = big2d("lm_head", "lm_head.weight", transpose=True)
    reader.close()
    logger.info("Loaded %s onto %s as %s%s", model_path, dev, dtype,
                f" ({quant_mode} weights)" if quant_mode else "")
    return params
