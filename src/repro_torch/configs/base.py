"""Model / shape configuration for the PyTorch port.

The port's own copy of the configuration system: ``LayerKind``/``Stage``
patterns, ``ModelConfig`` with its derived head width and ``reduced()``
smoke variant, the registry of every architecture the JAX package
configures, and the benchmark input shapes.  ``MLAConfig`` sizes
deepseek-v2's multi-head latent attention (``models/mla.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

MIXERS = ("attn", "local", "mla", "mamba", "enc", "dec", "none")
FFS = ("mlp", "moe", "none")


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str  # attn | local | mla | mamba | enc | dec | none
    ff: str     # mlp | moe | none

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ff not in FFS:
            raise ValueError(f"unknown ff {self.ff!r}")

    @property
    def tag(self) -> str:
        return f"{self.mixer}:{self.ff}"


def LK(mixer: str, ff: str) -> LayerKind:
    return LayerKind(mixer, ff)


@dataclasses.dataclass(frozen=True)
class Stage:
    """``pattern`` is applied in order, the whole pattern repeated
    ``repeats`` times; parameters of each pattern position are stacked on a
    leading repeat axis.  ``stream`` selects the token stream (decoder or
    encoder) the stage runs on."""

    pattern: Tuple[LayerKind, ...]
    repeats: int
    stream: str = "decoder"  # decoder | encoder

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden width
    n_shared_experts: int = 0     # always-on experts (deepseek-v2)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SparseAttnConfig:
    """Static block-sparse attention pattern (local band + sink blocks +
    strided global blocks); ``head_sparsity`` is the fraction of heads whose
    parameters are masked from federated communication."""

    block_size: int = 128
    local_blocks: int = 4
    sink_blocks: int = 1
    stride: int = 8
    head_sparsity: float = 0.4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio | encoder
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                     # dense-MLP hidden width (0 → none)
    vocab_size: int
    stages: Tuple[Stage, ...]
    head_dim: int = 0             # 0 → d_model // n_heads
    window: int = 0               # sliding window for "local" mixers
    norm: str = "rms"             # rms | ln
    act: str = "swiglu"           # swiglu | geglu | gelu
    pos: str = "rope"             # rope | learned
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False     # sqrt(d_model) embedding scale
    max_position: int = 0         # learned-pos table size (0 → derived per run)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    sparse_attn: Optional[SparseAttnConfig] = None
    n_prefix_tokens: int = 0      # VLM patch-embedding positions
    prefix_dim: int = 0
    encoder_seq: int = 0          # audio: post-conv frames
    n_classes: int = 0            # encoder classifier head
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def decoder_stages(self) -> Tuple[Stage, ...]:
        return tuple(s for s in self.stages if s.stream == "decoder")

    @property
    def encoder_stages(self) -> Tuple[Stage, ...]:
        return tuple(s for s in self.stages if s.stream == "encoder")

    @property
    def is_encoder_decoder(self) -> bool:
        return bool(self.encoder_stages) and bool(self.decoder_stages)

    @property
    def is_encoder_only(self) -> bool:
        return bool(self.encoder_stages) and not self.decoder_stages

    @property
    def attention_free(self) -> bool:
        return all(k.mixer in ("mamba", "none")
                   for s in self.stages for k in s.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if every long-context mixer path is sub-quadratic: SSM
        layers, sliding-window layers, or block-sparse attention enabled."""
        if self.attention_free:
            return True
        for s in self.stages:
            for k in s.pattern:
                if k.mixer in ("attn", "mla", "enc", "dec") and self.sparse_attn is None:
                    return False
                if k.mixer == "local" and self.window <= 0:
                    return False
        return True

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.headdim

    def param_count(self, include_embed: bool = True) -> int:
        """The analytic parameter count (the JAX package's, for the
        communication-cost accounting and the roofline)."""
        from repro_torch.models.blocks import layer_param_count   # local: no cycle

        total = 0
        if include_embed:
            total += self.vocab_size * self.d_model
            if not self.tie_embeddings:
                total += self.vocab_size * self.d_model
            if self.pos == "learned":
                total += max(self.max_position, 4096) * self.d_model
        for s in self.stages:
            for k in s.pattern:
                total += layer_param_count(self, k) * s.repeats
        total += self.d_model                                   # final norm
        if self.n_prefix_tokens:
            total += self.prefix_dim * self.d_model             # VLM projector
        if self.n_classes:
            total += self.d_model * self.n_classes
        return total

    def active_param_count(self) -> int:
        """The MoE-aware count of parameters active per token (MODEL_FLOPS
        = 6·N_active·D)."""
        from repro_torch.models.blocks import layer_param_count

        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for s in self.stages:
            for k in s.pattern:
                total += layer_param_count(self, k, active_only=True) * s.repeats
        return total + self.d_model

    def reduced(self, d_model: int = 256, repeats: int = 1, n_experts: int = 4,
                vocab: int = 512) -> "ModelConfig":
        """Reduced same-family variant for CPU tests: ≤2 layer kinds per
        stage pattern, ≤4 heads, ≤4 experts, the same widths ratio."""
        scale = d_model / self.d_model
        n_heads = max(2, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        hd = d_model // n_heads
        stages = tuple(Stage(s.pattern[: min(len(s.pattern), 2)],
                             min(s.repeats, repeats), s.stream)
                       for s in self.stages)
        moe = None
        if self.moe is not None:
            moe = MoEConfig(n_experts=min(self.moe.n_experts, n_experts),
                            top_k=min(self.moe.top_k, 2),
                            d_ff=max(32, int(self.moe.d_ff * scale)),
                            n_shared_experts=min(self.moe.n_shared_experts, 1),
                            capacity_factor=2.0)
        ssm = None
        if self.ssm is not None:
            ssm = SSMConfig(state=16, headdim=16, expand=self.ssm.expand,
                            chunk=32, conv_width=self.ssm.conv_width)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                            nope_head_dim=hd, v_head_dim=hd)
        sparse = self.sparse_attn
        if sparse is not None:
            sparse = SparseAttnConfig(block_size=16, local_blocks=2,
                                      sink_blocks=1, stride=4,
                                      head_sparsity=sparse.head_sparsity)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=max(32, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=vocab,
            stages=stages,
            window=min(self.window, 64) if self.window else 0,
            max_position=1024,
            moe=moe,
            ssm=ssm,
            mla=mla,
            sparse_attn=sparse,
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            prefix_dim=min(self.prefix_dim, 64) if self.prefix_dim else 0,
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name]


def list_configs():
    _load_all()
    return sorted(_REGISTRY)


ASSIGNED = (
    "whisper-base", "jamba-v0.1-52b", "mamba2-1.3b", "gemma3-12b",
    "dbrx-132b", "tinyllama-1.1b", "llama3.2-1b", "deepseek-67b",
    "internvl2-26b", "deepseek-v2-236b",
)

PAPER_OWN = ("gpt2-small", "roberta-base")


def _load_all():
    # import side effects register the configs
    from repro_torch.configs import (  # noqa: F401
        whisper_base, jamba_v0_1_52b, mamba2_1_3b, gemma3_12b, dbrx_132b,
        tinyllama_1_1b, llama3_2_1b, deepseek_67b, internvl2_26b,
        deepseek_v2_236b, gpt2_small, roberta_base,
    )
