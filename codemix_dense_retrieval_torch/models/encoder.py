"""TextEncoder — the user-facing encoding runtime.

Tokenize on the host (on a prefetch thread, in length-sorted batches padded
to a few bucket lengths), run the encoder on the device (pooling + L2 norm
included), return float32 numpy rows in input order (per-token document
embeddings stay on the device, for the token store's writer). Family
dialects apply their query / passage prompt prefixes.
"""

from __future__ import annotations

import itertools
import json
import pathlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from codemix_dense_retrieval_torch.models import dialects
from codemix_dense_retrieval_torch.models.convert import (
    load_hf_checkpoint,
    load_params_npz,
    params_from_flax,
)
from codemix_dense_retrieval_torch.models.tokenizer import (
    DEFAULT_BUCKETS,
    HashTokenizer,
    bucket_length,
    load_tokenizer,
)
from codemix_dense_retrieval_torch.models.xlmr import XLMRConfig, XLMREncoder, init_random_
from codemix_dense_retrieval_torch.utils.devices import DeviceLike, default_dtype, resolve_device


def build_model(cfg: XLMRConfig, device: torch.device, params=None, seed: int = 0) -> XLMREncoder:
    """XLMREncoder on ``device`` in ``cfg.dtype``, loaded from ``params`` (a
    state dict, or a Flax-layout tree) or, without them, randomly
    initialized from a ``torch.Generator`` seeded with ``seed``."""
    with torch.device("meta"):
        model = XLMREncoder(cfg)
    model = model.to_empty(device=device)
    if params is None:
        init_random_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        if "params" in params or "embeddings" in params:
            params = params_from_flax(params)
        model.load_state_dict(params, strict=True)
    return model.to(cfg.dtype).eval()


class TextEncoder:
    """Encoder facade: tokenizer + device forward + dialect handling."""

    _PREFETCH_DEPTH = 3

    def __init__(
        self,
        name: str,
        cfg: XLMRConfig,
        params: Optional[Mapping] = None,
        tokenizer=None,
        *,
        seed: int = 0,
        length_buckets: Sequence[int] = DEFAULT_BUCKETS,
        mesh=None,
        weight_quant: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError("multi-device encoding is not ported yet (ROADMAP queue 1, parallelism)")
        if weight_quant:
            raise NotImplementedError("weight quantization is not ported yet (ROADMAP queue 1, quantization)")
        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg
        self.model = build_model(cfg, self.device, params, seed)
        if tokenizer is None:
            tokenizer = HashTokenizer(
                vocab_size=cfg.vocab_size, max_length=cfg.max_position_embeddings - 2
            )
        self.tokenizer = tokenizer
        self.length_buckets = tuple(
            b for b in length_buckets if b <= cfg.max_position_embeddings - 2
        ) or (cfg.max_position_embeddings - 2,)

    @classmethod
    def from_checkpoint(
        cls,
        name: str,
        checkpoint_dir,
        *,
        dtype: Optional[torch.dtype] = None,
        use_flash: Optional[bool] = None,
        **kw,
    ) -> "TextEncoder":
        """Load either a converted checkpoint (``params.npz`` +
        ``encoder_config.json``) or an HF checkpoint directory (config.json +
        torch / safetensors weights). The compute dtype follows the device
        (bf16 on the card, f32 on the CPU) unless ``dtype`` is given;
        ``use_flash`` overrides the stored setting."""
        d = pathlib.Path(checkpoint_dir)
        device = resolve_device(kw.get("device"))
        dtype = dtype or default_dtype(device)
        if (d / "params.npz").exists() and (d / "encoder_config.json").exists():
            cfg_dict = json.loads((d / "encoder_config.json").read_text())
            cfg_dict.pop("dtype", None)
            if use_flash is not None:
                cfg_dict["use_flash"] = use_flash
            cfg = XLMRConfig(**cfg_dict, dtype=dtype)
            params = load_params_npz(d / "params.npz")
        else:
            extra = {} if use_flash is None else {"use_flash": use_flash}
            cfg, params = load_hf_checkpoint(
                d, pooling=dialects.default_pooling(name), dtype=dtype, **extra
            )
        tok = load_tokenizer(d, cfg.max_position_embeddings - 2, vocab_size=cfg.vocab_size)
        return cls(name, cfg, params, tok, **kw)

    # ------------------------------------------------------------------

    @staticmethod
    def _length_order(texts: Sequence[str]) -> np.ndarray:
        """Longest texts first (char length as the token-count proxy), stable,
        so each batch lands in the smallest bucket it can."""
        return np.argsort([-len(t) for t in texts], kind="stable")

    @staticmethod
    def _inverse(order: np.ndarray) -> np.ndarray:
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return inv

    def _batch_inputs(
        self, texts: Sequence[str], batch_size: int, prefix: str, max_length: Optional[int]
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (ids, mask) batches padded with the tokenizer's pad id to a
        bucket length; tokenization runs on a prefetch thread."""
        ml = max_length or (self.cfg.max_position_embeddings - 2)
        pad_id = getattr(self.tokenizer, "pad_id", 1)

        def prep(start: int):
            chunk = [prefix + t for t in texts[start : start + batch_size]]
            ids, mask = self.tokenizer.encode_batch(chunk, ml)
            s = bucket_length(ids.shape[1], self.length_buckets)
            ids_p = np.full((len(chunk), s), pad_id, np.int64)
            mask_p = np.zeros((len(chunk), s), np.int64)
            ids_p[:, : ids.shape[1]] = ids[:, :s]
            mask_p[:, : mask.shape[1]] = mask[:, :s]
            return ids_p, mask_p

        starts = iter(range(0, len(texts), batch_size))
        with ThreadPoolExecutor(max_workers=1) as ex:
            futs = deque(ex.submit(prep, s) for s in itertools.islice(starts, self._PREFETCH_DEPTH))
            while futs:
                out = futs.popleft().result()
                nxt = next(starts, None)
                if nxt is not None:
                    futs.append(ex.submit(prep, nxt))
                yield out

    def _encode(
        self,
        texts: Sequence[str],
        batch_size: int,
        prefix: str,
        max_length: Optional[int],
        readback_dtype: Optional[torch.dtype] = None,
    ) -> np.ndarray:
        order = self._length_order(texts)
        texts = [texts[i] for i in order]
        outs = []
        with torch.inference_mode():
            for ids, mask in self._batch_inputs(texts, batch_size, prefix, max_length):
                emb = self.model(
                    torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
                )
                if readback_dtype is not None:
                    emb = emb.to(readback_dtype)
                outs.append(emb)
        if not outs:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        out = torch.cat(outs).to("cpu", torch.float32).numpy()
        return out[self._inverse(order)]

    def encode_queries(
        self, texts: Sequence[str], batch_size: int = 64, max_length: Optional[int] = None
    ) -> np.ndarray:
        return self._encode(texts, batch_size, dialects.query_prefix(self.name), max_length)

    def encode_documents(
        self,
        texts: Sequence[str],
        batch_size: int = 64,
        max_length: Optional[int] = None,
        readback_dtype: Optional[torch.dtype] = None,
        pack: bool = False,
    ) -> np.ndarray:
        """``readback_dtype`` (e.g. ``torch.bfloat16``) casts on the device
        before the device -> host copy; the returned array is always f32."""
        if pack:
            raise NotImplementedError("sequence packing is not ported yet (ROADMAP queue 1, packing)")
        return self._encode(
            texts, batch_size, dialects.doc_prefix(self.name), max_length,
            readback_dtype=readback_dtype,
        )

    # ------------------------------------------------------------------
    # per-token embeddings (two-stage MaxSim)

    def _stack_tokens(self, outs, order: np.ndarray) -> torch.Tensor:
        """Length-sorted (n_i, T_i, d) batches -> (n, T, d) f32 on the
        encoder's device in input order, T the longest bucketed batch
        length, shorter batches zero-padded."""
        t_max = max(int(t.shape[1]) for t in outs)
        out = torch.zeros(
            (sum(t.shape[0] for t in outs), t_max, self.cfg.hidden_size),
            dtype=torch.float32, device=self.device,
        )
        pos = 0
        for t in outs:
            out[pos : pos + t.shape[0], : t.shape[1]] = t
            pos += t.shape[0]
        return out[torch.from_numpy(self._inverse(order)).to(self.device)]

    def _encode_tokens(
        self,
        texts: Sequence[str],
        batch_size: int,
        prefix: str,
        max_length: Optional[int],
        max_tokens: Optional[int] = None,
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """Per-token embeddings for multi-vector serving: (tokens (n, T, d)
        f32 on the encoder's device, valid-token lengths (n,) int32). With
        ``max_tokens`` each batch keeps only its first ``max_tokens`` tokens
        on the card (the lengths stay the full valid counts)."""
        order = self._length_order(texts)
        texts = [texts[i] for i in order]
        outs, lengths = [], []
        with torch.inference_mode():
            for ids, mask in self._batch_inputs(texts, batch_size, prefix, max_length):
                lengths.append(mask.sum(axis=1).astype(np.int32))
                t = self.model.token_embeddings(
                    torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
                )
                outs.append(t[:, :max_tokens].contiguous())
        if not outs:
            return torch.zeros((0, 0, self.cfg.hidden_size), device=self.device), np.zeros(0, np.int32)
        return self._stack_tokens(outs, order), np.concatenate(lengths)[self._inverse(order)]

    def encode_documents_with_tokens(
        self,
        texts: Sequence[str],
        batch_size: int = 64,
        max_length: Optional[int] = None,
        pack: bool = False,
        max_tokens: Optional[int] = None,
    ) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
        """One forward pass -> (dense (n, d) f32, tokens (n, T, d) f32,
        lengths (n,)): the corpus encode builds the flat index and the token
        store together. The tokens stay on the encoder's device, where the
        token store's writer masks and quantizes them before they reach the
        host; ``max_tokens`` (the store's tokens per doc) keeps only the
        first tokens of each batch there."""
        if pack:
            raise NotImplementedError(
                "sequence packing is not ported yet: ROADMAP queue 1, item 11 (sequence packing)"
            )
        order = self._length_order(texts)
        texts = [texts[i] for i in order]
        dense, outs, lengths = [], [], []
        with torch.inference_mode():
            for ids, mask in self._batch_inputs(texts, batch_size, dialects.doc_prefix(self.name), max_length):
                lengths.append(mask.sum(axis=1).astype(np.int32))
                dv, tv = self.model.embed_with_tokens(
                    torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
                )
                dense.append(dv.cpu().numpy())
                outs.append(tv[:, :max_tokens].contiguous())
        d = self.cfg.hidden_size
        if not outs:
            return (np.zeros((0, d), np.float32), torch.zeros((0, 0, d), device=self.device),
                    np.zeros(0, np.int32))
        inv = self._inverse(order)
        return np.concatenate(dense)[inv], self._stack_tokens(outs, order), np.concatenate(lengths)[inv]

    def encode_queries_tokens(
        self, texts: Sequence[str], batch_size: int = 64, max_length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens (n, T, d) f32 on the host, lengths (n,) int32)."""
        toks, lens = self._encode_tokens(texts, batch_size, dialects.query_prefix(self.name), max_length)
        return toks.cpu().numpy(), lens

    def encode_documents_tokens(
        self,
        texts: Sequence[str],
        batch_size: int = 64,
        max_length: Optional[int] = None,
        max_tokens: Optional[int] = None,
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """(tokens (n, T, d) f32 on the encoder's device, lengths (n,) int32),
        for the token store's writer; ``max_tokens`` as in
        :meth:`encode_documents_with_tokens`."""
        return self._encode_tokens(
            texts, batch_size, dialects.doc_prefix(self.name), max_length, max_tokens
        )

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size
