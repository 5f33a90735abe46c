"""BERT-base clinical text encoder.

Architecture-compatible with the reference's HF `AutoModel` BERT encoders
(BioBERT / ClinicalBERT / PubMedBERT, `src/text_encoder.py:27-239`):
word+position+segment embeddings → 12 post-LN transformer layers → CLS
token (default) or tanh pooler. Converted HF checkpoints load directly
into this module's param tree (see `models/convert.py`).

All shapes are static (pad-to-max tokenization), attention is the
standard XLA softmax(QK^T/sqrt(d))V in bf16 with f32 softmax; per-layer
attention probabilities are exposed for the explainability path (ref
`src/text_encoder.py:151-179`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from multimodal_rare_disease import nn

from multimodal_rare_disease.config import TextEncoderConfig

Dtype = Any

# HF BertModel init semantics (`_init_weights`): every Linear/Embedding
# weight ~ N(0, initializer_range=0.02), biases zero, LayerNorm 1/0.
# This matters beyond cosmetics: with the layer defaults (lecun_normal
# kernels, Embed stddev 1.0) a from-scratch post-LN BERT stops training
# at >=4 layers with the 3072-wide FFN (loss pinned at ln(num_classes));
# the small-residual-branch N(0, 0.02) init restores HF's from-scratch
# trainability.
_HF_INIT = nn.initializers.normal(stddev=0.02)


def _gelu_exact_erf(x: jnp.ndarray) -> jnp.ndarray:
    """Exact GELU via lax.erf: x/2 * (1 + erf(x/sqrt(2))).

    Same math as HF BERT's "gelu" activation (torch.nn.functional.gelu
    default, ref `src/text_encoder.py` encoder stacks), but deliberately
    NOT jax.nn.gelu(approximate=False): that lowers through erfc, whose
    XLA expansion is a ~60-op f32 rational (with exp and divides) per
    element that XLA may recompute as a matmul prologue. lax.erf's f32
    expansion is a short polynomial.
    """
    xf = x.astype(jnp.float32)
    y = 0.5 * xf * (1.0 + jax.lax.erf(xf * np.float32(0.7071067811865476)))
    return y.astype(x.dtype)


class BertSelfAttention(nn.Module):
    hidden_size: int
    num_heads: int
    dropout: float
    quantized: bool = False
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, hidden, attention_bias, attention_mask=None,
                 train: bool = False, output_attentions: bool = False,
                 cls_query_only: bool = False,
                 query_positions=None):
        """`query_positions` [B, P] (with cls_query_only) generalizes the
        CLS-only fast path to sequence-packed batches: Q is computed
        for those positions only (one per packed document), K/V stay
        full-sequence. Numerically identical to slicing the full
        forward at the same positions."""
        from multimodal_rare_disease.models.quant import (
            MaybeQuantDenseGeneral,
        )

        # The residual stream arrives either as [B, T, H] (classic) or
        # flattened [B*T, H] (flat mode, see BertEncoder.flat_residual);
        # attention is the only sublayer that needs the [B, T, ...] view,
        # so it reshapes around its core and hands back the caller's rank.
        flat = hidden.ndim == 2
        if flat:
            B = attention_bias.shape[0]
            T = hidden.shape[0] // B
            H = hidden.shape[-1]
        else:
            B, T, H = hidden.shape
        d = self.hidden_size // self.num_heads
        q8 = self.quantized and not train
        # fused QKV: one [H, 3, h, d] matmul instead of three [H, h, d]
        # (one larger GEMM; HF q/k/v weights concat into this kernel at
        # conversion time, models/convert.py)
        qkv_mod = MaybeQuantDenseGeneral((3, self.num_heads, d), axis=-1,
                                         quantized=q8,
                                         dtype=self.dtype,
                                         param_dtype=self.param_dtype,
                                         kernel_init=_HF_INIT,
                                         name="qkv")
        hd = self.num_heads * d
        if cls_query_only and not q8:
            # final-layer fast path: only the CLS position is consumed
            # downstream, so compute Q for position 0 only and K/V for
            # the full sequence — skips (T-1)/T of the Q projection.
            # Same params via
            # return_weights ([H, 3*h*d] row-major = Q block first);
            # same dtype-dot semantics as the module's own path, so
            # numerically identical to slicing the fused output.
            w2d, b_all = qkv_mod(hidden, return_weights=True)
            h2 = hidden if flat else hidden.reshape(B * T, H)
            if query_positions is not None:
                h3 = h2.reshape(B, T, H)
                q_rows = jnp.take_along_axis(
                    h3, query_positions[:, :, None], axis=1)  # [B,P,H]
                P = q_rows.shape[1]
            else:
                q_rows = h2[::T] if flat else hidden[:, 0]
                P = 1
            dt = self.dtype
            q = (jnp.dot(q_rows.reshape(B * P, H).astype(dt),
                         w2d[:, :hd].astype(dt))
                 + b_all[:hd].astype(dt)).reshape(B, P, self.num_heads, d)
            kv = (jnp.dot(h2.astype(dt), w2d[:, hd:].astype(dt))
                  + b_all[hd:].astype(dt)).reshape(B, T, 2,
                                                   self.num_heads, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
        else:
            qkv = qkv_mod(hidden)  # [B,T,3,h,d]
            if flat:
                qkv = qkv.reshape(B, T, 3, self.num_heads, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if cls_query_only:
                # quantized fallback: restrict the query to the consumed
                # positions (numerically identical to slicing the output)
                if query_positions is not None:
                    q = jnp.take_along_axis(
                        q, query_positions[:, :, None, None], axis=1)
                else:
                    q = q[:, :1]

        # Pad the attention core to a multiple of 128 positions when T
        # is not one (e.g. T=96), so the einsums run on aligned shapes
        # (kept from the first design; not yet measured on the GPU).
        # Padded keys carry a -1e9
        # additive bias so exp(bias - max) underflows to exactly 0.0 in
        # f32 — the softmax denominator and the AV contraction are
        # bit-identical to the unpadded forward (padded V rows are
        # zero), and padded query rows are sliced off. Inference-only:
        # under train the probs-dropout RNG shape would change draws.
        pad_t = 0
        if (not train and not output_attentions and T % 128 != 0
                and T > 64 and attention_bias.shape[2] == 1):
            pad_t = 128 - T % 128
            k = jnp.pad(k, ((0, 0), (0, pad_t), (0, 0), (0, 0)))
            v = jnp.pad(v, ((0, 0), (0, pad_t), (0, 0), (0, 0)))
            if not cls_query_only:
                q = jnp.pad(q, ((0, 0), (0, pad_t), (0, 0), (0, 0)))
            attention_bias = jnp.pad(attention_bias,
                                     ((0, 0), (0, 0), (0, 0), (0, pad_t)),
                                     constant_values=-1e9)
            if attention_mask is not None:
                attention_mask = jnp.pad(attention_mask,
                                         ((0, 0), (0, pad_t)))

        if cls_query_only and attention_bias.shape[2] > 1:
            # packed 2-D mask [B,1,T,T]: keep only the restricted
            # queries' bias rows -> [B,1,P,T]
            if query_positions is not None:
                attention_bias = jnp.take_along_axis(
                    attention_bias, query_positions[:, None, :, None],
                    axis=2)
            else:
                attention_bias = attention_bias[:, :, :1]

        # Plain XLA attention: batched einsums with an f32 softmax.
        scores = jnp.einsum("bthd,bshd->bhts", q, k) \
            / jnp.sqrt(d).astype(self.dtype)
        scores = scores + attention_bias  # [B,1,1,T] additive mask
        probs = nn.softmax(scores.astype(jnp.float32),
                           axis=-1).astype(self.dtype)
        probs_dropped = nn.Dropout(rate=self.dropout)(
            probs, deterministic=not train)
        ctx = jnp.einsum("bhts,bshd->bthd", probs_dropped, v)
        if pad_t and not cls_query_only:
            ctx = ctx[:, :T]  # drop the padded query rows
        if flat:
            ctx = ctx.reshape(B * ctx.shape[1], self.num_heads, d)
        out = MaybeQuantDenseGeneral(
            H, axis=(-2, -1), quantized=q8, dtype=self.dtype,
            param_dtype=self.param_dtype, kernel_init=_HF_INIT,
            name="output")(ctx)
        if output_attentions:
            return out, probs
        return out, None


class BertLayer(nn.Module):
    hidden_size: int
    num_heads: int
    intermediate_size: int
    dropout: float
    quantized: bool = False
    pre_ln: bool = False
    ln_barrier: bool = False
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, hidden, attention_bias, attention_mask=None,
                 train: bool = False, output_attentions: bool = False,
                 cls_only: bool = False, query_positions=None):
        from multimodal_rare_disease.models.quant import (
            MaybeQuantDenseGeneral,
        )

        # pre_ln=True applies the same two LayerNorms BEFORE their
        # sublayers (GPT-2/ViT placement) instead of after the residual
        # (HF BERT). Post-LN is the conversion-parity default; pre-LN is
        # the from-scratch trainability option: at 12x3072 on tiny
        # corpora the post-LN stack sits at the uniform-logits attractor
        # (docs/TRAINING.md scale cliff) while pre-LN descends.
        ln_att = nn.LayerNorm(epsilon=1e-12, dtype=self.dtype,
                              param_dtype=self.param_dtype,
                              name="attention_ln")
        ln_out = nn.LayerNorm(epsilon=1e-12, dtype=self.dtype,
                              param_dtype=self.param_dtype,
                              name="output_ln")

        # Optional fusion barrier between each residual add and its
        # LayerNorm (identity on values and gradients): forces the
        # residual to materialise instead of letting XLA fuse the LN's
        # f32 statistics into the preceding matmul epilogue. Off by
        # default.
        def _fb(x):
            return jax.lax.optimization_barrier(x) if self.ln_barrier else x

        q8 = self.quantized and not train
        attn_in = ln_att(_fb(hidden)) if self.pre_ln else hidden
        attn_out, probs = BertSelfAttention(
            self.hidden_size, self.num_heads, self.dropout,
            quantized=self.quantized,
            dtype=self.dtype, param_dtype=self.param_dtype, name="attention",
        )(attn_in, attention_bias, attention_mask=attention_mask, train=train,
          output_attentions=output_attentions, cls_query_only=cls_only,
          query_positions=query_positions)
        if cls_only:
            # the rest of the layer (residual, LNs, FFN) runs on the
            # consumed positions only — one per (packed) document
            # (numerics unchanged)
            if hidden.ndim == 2:  # flat [B*T, H] stream → [B, H]
                B = attention_bias.shape[0]
                hidden = hidden.reshape(B, -1, hidden.shape[-1])[:, 0]
            elif query_positions is not None:
                hidden = jnp.take_along_axis(
                    hidden, query_positions[:, :, None], axis=1)
            else:
                hidden = hidden[:, :1]

        attn_out = nn.Dropout(rate=self.dropout)(
            attn_out, deterministic=not train)
        if self.pre_ln:
            hidden = hidden + attn_out
            ffn_in = ln_out(_fb(hidden))
        else:
            hidden = ln_att(_fb(hidden + attn_out))
            ffn_in = hidden

        inter = _gelu_exact_erf(MaybeQuantDenseGeneral(
            self.intermediate_size, quantized=q8, dtype=self.dtype,
            param_dtype=self.param_dtype, kernel_init=_HF_INIT,
            name="intermediate")(ffn_in))
        out = MaybeQuantDenseGeneral(
            self.hidden_size, quantized=q8, dtype=self.dtype,
            param_dtype=self.param_dtype, kernel_init=_HF_INIT,
            name="output")(inter)
        out = nn.Dropout(rate=self.dropout)(out, deterministic=not train)
        if self.pre_ln:
            hidden = hidden + out
        else:
            hidden = ln_out(_fb(hidden + out))
        return hidden, probs


class BertEncoder(nn.Module):
    """BERT-base encoder returning a dict of outputs."""

    vocab_size: int = 28996
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    quantized: bool = False
    pre_ln: bool = False
    ln_barrier: bool = False
    flat_residual: bool = False
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jnp.ndarray,        # [B, T] int32
        attention_mask: jnp.ndarray,   # [B, T] {0,1}
        token_type_ids: Optional[jnp.ndarray] = None,
        train: bool = False,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
        cls_only_final: bool = False,
        position_ids: Optional[jnp.ndarray] = None,
        segment_ids: Optional[jnp.ndarray] = None,
        query_positions: Optional[jnp.ndarray] = None,
    ) -> Dict[str, Any]:
        """When `cls_only_final` (inference fast path), the LAST layer
        computes only the CLS position (its query attends over the full
        sequence — numerically identical to slicing the full forward at
        position 0) and `last_hidden_state` comes out as [B, 1, H].
        Ignored when full hidden states / attentions are requested.

        Sequence-packed batches (inference/packing.py): several short
        documents share one row. `segment_ids` [B, T] (0 = pad, 1..k =
        document) builds a block-diagonal attention mask, so cross-
        document scores carry a -1e9 bias whose softmax contribution
        underflows to exactly 0 — per-document outputs are bit-identical
        to the unpacked forward. `position_ids` [B, T] restarts positions
        at each document start; `query_positions` [B, P] are the CLS
        positions (one per document) the final layer computes, and
        `cls`/`pooler_output` come out as [B, P, H]."""
        B, T = input_ids.shape
        cls_only_final = (cls_only_final and not output_hidden_states
                          and not output_attentions)
        packed = segment_ids is not None
        if position_ids is not None:
            positions = position_ids
        else:
            positions = jnp.arange(T)[None, :]

        word = nn.Embed(self.vocab_size, self.hidden_size,
                        param_dtype=self.param_dtype, dtype=self.dtype,
                        embedding_init=_HF_INIT, name="word_embeddings")(input_ids)
        pos = nn.Embed(self.max_position_embeddings, self.hidden_size,
                       param_dtype=self.param_dtype, dtype=self.dtype,
                       embedding_init=_HF_INIT, name="position_embeddings")(positions)
        seg_mod = nn.Embed(self.type_vocab_size, self.hidden_size,
                           param_dtype=self.param_dtype, dtype=self.dtype,
                           embedding_init=_HF_INIT,
                           name="token_type_embeddings")
        if token_type_ids is None:
            # single-segment fast path: every position embeds row 0, so
            # look up one row and broadcast instead of a [B*T]-row gather
            seg = seg_mod(jnp.zeros((1, 1), jnp.int32))
        else:
            seg = seg_mod(token_type_ids)
        hidden = word + pos + seg
        hidden = nn.LayerNorm(epsilon=1e-12, dtype=self.dtype,
                              param_dtype=self.param_dtype,
                              name="embeddings_ln")(hidden)
        hidden = nn.Dropout(rate=self.dropout)(hidden, deterministic=not train)

        # additive attention bias: 0 for real tokens, large negative for pad
        if packed:
            # block-diagonal: key allowed iff same nonzero document id
            same = segment_ids[:, :, None] == segment_ids[:, None, :]
            allowed = same & (segment_ids[:, None, :] != 0)
            bias = jnp.where(allowed, 0.0, -1e9)[:, None]  # [B,1,T,T]
        else:
            bias = (1.0 - attention_mask[:, None, None, :]
                    .astype(jnp.float32)) * -1e9
        bias = bias.astype(self.dtype)

        # Flat-2D residual stream: keep hidden as [B*T, H] between layers
        # so every FFN/projection dot is an unambiguous [B*T, K] x [K, N]
        # matmul. The values are identical (pure reshapes); attention
        # reshapes to [B, T, ...] around its core. Viz paths (hidden
        # states / attentions) keep the classic 3D stream.
        flat = (self.flat_residual and not output_hidden_states
                and not output_attentions and not packed)
        if flat:
            hidden = hidden.reshape(B * T, self.hidden_size)

        all_hidden = [hidden] if output_hidden_states else None
        all_attn = [] if output_attentions else None
        for i in range(self.num_layers):
            hidden, probs = BertLayer(
                self.hidden_size, self.num_heads, self.intermediate_size,
                self.dropout,
                quantized=self.quantized, pre_ln=self.pre_ln,
                ln_barrier=self.ln_barrier,
                dtype=self.dtype, param_dtype=self.param_dtype,
                name=f"layer{i}",
            )(hidden, bias,
              attention_mask=None if packed else attention_mask,
              train=train,
              output_attentions=output_attentions,
              cls_only=cls_only_final and i == self.num_layers - 1,
              query_positions=query_positions if packed else None)
            if output_hidden_states:
                all_hidden.append(hidden)
            if output_attentions:
                all_attn.append(probs)

        if self.pre_ln:
            # pre-LN stacks need one final normalization before readout
            hidden = nn.LayerNorm(epsilon=1e-12, dtype=self.dtype,
                                  param_dtype=self.param_dtype,
                                  name="final_ln")(hidden)
        if flat:
            # back to [B, T', H] for the public contract (T'=1 after the
            # cls-only final layer, where the stream is already [B, H])
            hidden = hidden.reshape(B, -1, self.hidden_size)
        if packed and query_positions is not None:
            if cls_only_final:
                cls = hidden  # already the P query positions: [B, P, H]
            else:
                cls = jnp.take_along_axis(
                    hidden, query_positions[:, :, None], axis=1)
        else:
            cls = hidden[:, 0, :]
        pooled = nn.Dense(self.hidden_size, dtype=self.dtype,
                          param_dtype=self.param_dtype,
                          kernel_init=_HF_INIT, name="pooler")(cls)
        pooled = jnp.tanh(pooled)

        out: Dict[str, Any] = {
            "last_hidden_state": hidden,
            "cls": cls,
            "pooler_output": pooled,
        }
        if output_hidden_states:
            out["hidden_states"] = tuple(all_hidden)
        if output_attentions:
            out["attentions"] = tuple(all_attn)
        return out


class TextEncoder(nn.Module):
    """Text encoder wrapper: BERT → [B, 768] embedding (+ optional projection).

    Parity with the reference's `TextEncoder` / `TextEncoderWithProjection`
    (`src/text_encoder.py:27-269`): embedding = CLS token by default, or
    the tanh pooler when use_pooler_output; dropout on top; optional
    projection head to `projection_dim`.
    """

    vocab_size: int = 28996
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    bert_dropout: float = 0.1
    dropout: float = 0.1
    use_pooler_output: bool = False
    projection_dim: int = 0  # 0 = no projection (raw 768-d)
    quantized: bool = False
    pre_ln: bool = False
    ln_barrier: bool = False
    flat_residual: bool = False
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.bert = BertEncoder(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            max_position_embeddings=self.max_position_embeddings,
            type_vocab_size=self.type_vocab_size,
            dropout=self.bert_dropout,
            quantized=self.quantized,
            pre_ln=self.pre_ln,
            ln_barrier=self.ln_barrier,
            flat_residual=self.flat_residual,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="bert",
        )
        self.drop = nn.Dropout(rate=self.dropout)
        if self.projection_dim:
            self.proj = nn.Dense(self.projection_dim, dtype=self.dtype,
                                 param_dtype=self.param_dtype, name="projection")

    def __call__(
        self,
        input_ids: jnp.ndarray,
        attention_mask: jnp.ndarray,
        token_type_ids: Optional[jnp.ndarray] = None,
        train: bool = False,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
        position_ids: Optional[jnp.ndarray] = None,
        segment_ids: Optional[jnp.ndarray] = None,
        query_positions: Optional[jnp.ndarray] = None,
    ):
        out = self.bert(
            input_ids,
            attention_mask,
            token_type_ids=token_type_ids,
            train=train,
            output_hidden_states=output_hidden_states,
            output_attentions=output_attentions,
            # the embedding consumed here is always position 0 (CLS or
            # pooler), so inference can skip the last layer's other T-1
            # positions entirely; full forward when states are requested
            cls_only_final=not train,
            position_ids=position_ids,
            segment_ids=segment_ids,
            query_positions=query_positions,
        )
        emb = out["pooler_output"] if self.use_pooler_output else out["cls"]
        emb = self.drop(emb, deterministic=not train)
        if self.projection_dim:
            emb = self.proj(emb)
            emb = nn.relu(emb)
        if output_hidden_states or output_attentions:
            return emb, out
        return emb


def create_text_encoder(
    cfg: TextEncoderConfig,
    dtype: Dtype = jnp.float32,
    param_dtype: Dtype = jnp.float32,
    projection_dim: int = 0,
    name: str = None,
) -> TextEncoder:
    """Factory, parity with `create_text_encoder` (`src/text_encoder.py:272`)."""
    return TextEncoder(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size,
        bert_dropout=cfg.dropout,
        dropout=cfg.dropout,
        use_pooler_output=cfg.use_pooler_output,
        projection_dim=projection_dim,
        quantized=cfg.quantized_inference,
        pre_ln=getattr(cfg, "pre_layernorm", False),
        flat_residual=getattr(cfg, "flat_residual", False),
        dtype=dtype,
        param_dtype=param_dtype,
        name=name,
    )
