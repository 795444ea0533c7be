"""Configuration records: own copies of ``repro.configs.base``'s
``ModelConfig``, ``DiffusionConfig``, ``SpeCaConfig``, ``TrainConfig`` and
``reduced()``, ``ShapeConfig`` and ``MeshConfig``, of the four workload
shapes of ``repro.configs.shapes`` (``SHAPES``, :func:`get_shape`), and of
the registry of ``repro.configs``: the ten assigned architectures
(``ASSIGNED``) and the paper's three DiTs (``PAPER_ARCHS``), resolved by
:func:`get_config` (with the ``+swa`` sliding-window variant), listed by
:func:`list_archs`, and mapped to the arch that runs the long-context
shape by :func:`long_context_arch`.

Each record keeps the reference's fields that the port reads, with the
reference's names and defaults. The port serves DiT image and video
models conditioned on class labels or on a continuous text embedding
(``cond_dim``), and decoder-only LMs of every family of the reference:
dense, VLM text decode, MoE, SSM (Mamba2 SSD), hybrid (attention and
SSD in parallel) and multi-codebook audio. ``dtype`` stays a string and
maps to a torch dtype through :attr:`ModelConfig.torch_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name (``"bfloat16"``, ``"float32"``…)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} "
                         f"(have {sorted(_DTYPES)})") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A DiT (``arch_type="dit"``, the default: AdaLN-Zero blocks of
    bidirectional attention and a GELU MLP over patch tokens, conditioned
    on class labels and/or a continuous ``[B, T_text, cond_dim]``
    embedding) or a decoder-only LM: ``"dense"``/``"vlm"`` (causal GQA
    attention with RoPE, a SwiGLU or GELU MLP, RMSNorm), ``"moe"`` (the
    MLP replaced by top-k experts), ``"ssm"`` (a Mamba2 SSD mixer, no
    attention), ``"hybrid"`` (attention and SSD averaged, then the MLP)
    or ``"audio"`` (``num_codebooks`` summed embeddings and heads).
    ``num_kv_heads`` 0 resolves to ``num_heads``."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    arch_type: str = "dit"
    num_kv_heads: int = 0         # 0 -> num_heads
    vocab_size: int = 0
    head_dim: int = 0             # 0 -> d_model // num_heads
    attn_window: int = 0          # 0 = full attention; >0 = sliding window
    global_every: int = 0         # every Nth layer global (window patterns)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE (t, h, w) splits
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_aux_loss_weight: float = 0.01   # Switch load-balance loss weight
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0            # 0 -> derived: d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # --- audio (musicgen-style multi-codebook) ---
    num_codebooks: int = 0
    # --- VLM frontend stub: patch embeddings ahead of the text ---
    frontend_tokens: int = 0
    frontend_dim: int = 0
    norm_eps: float = 1e-5
    act: str = "silu"             # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    patch_size: int = 2
    in_channels: int = 4
    num_classes: int = 0          # the label table has one more (null) row
    cond_dim: int = 0             # continuous conditioning (text-embed stub)
    dtype: str = "bfloat16"
    source: str = ""              # citation for the configuration

    def __post_init__(self) -> None:
        if not self.num_kv_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """The vocabulary rounded up to a multiple of 256 (the reference's
        embedding and head width); ``lm_logits`` masks the padding
        columns to −1e30."""
        if self.vocab_size == 0:
            return 0
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.arch_type == "hybrid"

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(self.ssm_d_inner // self.ssm_head_dim, 1)

    @property
    def is_diffusion(self) -> bool:
        return self.arch_type == "dit"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def layer_window(self, layer_idx: int) -> int:
        """Effective attention window of a layer (0 = global/full)."""
        if self.attn_window <= 0:
            return 0
        if self.global_every > 0 and (layer_idx + 1) % self.global_every == 0:
            return 0
        return self.attn_window

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head), the
        reference's formula."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.num_heads * hd            # q
            per_layer += 2 * d * self.num_kv_heads * hd     # k, v
            per_layer += self.num_heads * hd * d            # o
        if self.is_moe:
            per_layer += d * self.num_experts               # router
            per_layer += self.num_experts * 3 * d * self.d_ff
        elif self.d_ff > 0:
            mult = 3 if self.act == "silu" else 2
            per_layer += mult * d * self.d_ff
        if self.is_ssm or self.is_hybrid:
            di, ns = self.ssm_d_inner, self.ssm_state
            nh = self.resolved_ssm_heads
            per_layer += d * (2 * di + 2 * ns * nh + nh)  # in: x,z,B,C,dt
            per_layer += di * d                              # out_proj
            per_layer += (di + 2 * ns * nh) * self.ssm_conv  # conv
        per_layer += 2 * d  # norms
        return n + L * per_layer

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: the top-k experts only)."""
        full = self.param_count()
        if not self.is_moe:
            return full
        inactive = self.num_experts - self.num_experts_per_tok
        return full - self.num_layers * inactive * 3 * self.d_model \
            * self.d_ff


LM_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_lm(cfg: ModelConfig, what: str) -> None:
    """Raise ``ValueError`` unless ``cfg`` is an autoregressive LM."""
    if cfg.arch_type not in LM_FAMILIES:
        raise ValueError(f"{what}: arch_type={cfg.arch_type!r} is not an "
                         f"autoregressive LM (have {LM_FAMILIES})")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (workload)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))


TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256,
                       kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32_768,
                          global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32_768,
                         global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1,
                        kind="decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


@dataclasses.dataclass(frozen=True)
class SpeCaConfig:
    """Paper hyper-parameters (§3.4, Appendix B)."""

    taylor_order: int = 2          # m in eq. (2)
    max_draft: int = 8             # K: max consecutive speculative steps
    tau0: float = 0.3              # base threshold τ0
    beta: float = 0.9              # decay β in τ_t = τ0 · β^((T−t)/T)
    verify_layer: int = -1         # block index verified each draft step
    error_metric: str = "rel_l2"   # rel_l2 | rel_l1 | rel_linf | cosine
    eps: float = 1e-8              # ε in eq. (4)
    table_dtype: str = ""          # "" = the model dtype


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    num_train_timesteps: int = 1000
    num_inference_steps: int = 50
    schedule: str = "cosine"       # linear | cosine | rectified_flow
    latent_size: int = 32          # spatial latent H=W
    guidance_scale: float = 1.0    # CFG scale of SpeCaEngine(guidance=True)
    num_frames: int = 1            # >1 => video (3D tokens)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 1024
    global_batch: int = 8
    steps: int = 200
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    seed: int = 0
    log_every: int = 20


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            d_ff: int = 0, vocab: int = 512, experts: int = 0,
            heads: int = 0) -> ModelConfig:
    """Smoke-test variant of the same family (≤2 layers, d_model ≤ 512),
    field for field the reference's."""
    num_heads = heads or max(min(cfg.num_heads, 4), 1)
    ratio = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
    num_kv = max(num_heads // ratio, 1)
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        d_ff=d_ff or (d_model * 2 if cfg.d_ff else 0),
        vocab_size=min(cfg.vocab_size, vocab),
        head_dim=d_model // num_heads if cfg.has_attention else 0,
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else 0,
        global_every=min(cfg.global_every, 2) if cfg.global_every else 0,
        dtype="float32",
    )
    if cfg.is_moe:
        changes["num_experts"] = experts or min(cfg.num_experts, 4)
        changes["num_experts_per_tok"] = min(cfg.num_experts_per_tok, 2)
        changes["moe_capacity_factor"] = 4.0  # deterministic small tests
    if cfg.is_ssm or cfg.is_hybrid:
        changes["ssm_state"] = min(cfg.ssm_state, 16)
        changes["ssm_head_dim"] = 32
        changes["ssm_chunk"] = 16
    if cfg.mrope_sections:
        hd = changes["head_dim"]
        changes["mrope_sections"] = (hd // 2 - 2 * (hd // 8), hd // 8,
                                     hd // 8)
    if cfg.frontend_tokens:
        changes["frontend_tokens"] = 16
        changes["frontend_dim"] = d_model
    return dataclasses.replace(cfg, **changes)


# DiT-XL/2 — the paper's class-conditional image model [arXiv:2212.09748]:
# 28 layers, d_model 1152, 16 heads, patch 2, ImageNet classes.
DIT_XL2 = ModelConfig(
    name="dit-xl2",
    num_layers=28,
    d_model=1152,
    num_heads=16,
    d_ff=4608,
    act="gelu",
    patch_size=2,
    in_channels=4,
    num_classes=1000,
    source="arXiv:2212.09748 (paper's own model)",
)

# FLUX.1-dev-like rectified-flow DiT [github:black-forest-labs/flux]: the
# single-stream-equivalent backbone of the 12B MMDiT, text-conditioned
# through a continuous embedding stub (the T5/CLIP encoders are frontends
# outside the paper's contribution); 50 rectified-flow steps.
FLUX_LIKE = ModelConfig(
    name="flux-like",
    num_layers=38,
    d_model=3072,
    num_heads=24,
    num_kv_heads=24,
    d_ff=12288,
    act="gelu",
    patch_size=2,
    in_channels=16,
    cond_dim=768,
    source="FLUX.1-dev (paper's own model), rectified flow",
)

# HunyuanVideo-like text-to-video DiT [arXiv:2411.02265]: the video
# backbone over (frames × H × W) latent tokens with a text stub.
HUNYUAN_VIDEO_LIKE = ModelConfig(
    name="hunyuan-video-like",
    num_layers=40,
    d_model=3072,
    num_heads=24,
    num_kv_heads=24,
    d_ff=12288,
    act="gelu",
    patch_size=2,
    in_channels=16,
    cond_dim=768,
    source="HunyuanVideo (paper's own model)",
)

# Llama-3-8B — dense, GQA (32 query heads on 8 KV heads), 128k vocabulary
# [arXiv:2407.21783]
LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)

# granite-moe-1b-a400m — MoE, 32 experts top-8
# [hf:ibm-granite/granite-3.0-1b-a400m-base]
GRANITE_MOE_1B_A400M = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    num_experts_per_tok=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

# mamba2-130m — SSD (state-space duality), attention-free
# [arXiv:2405.21060]
MAMBA2_130M = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

# hymba-1.5b — parallel attention + mamba heads in each block; sliding
# windows with every 16th layer global [arXiv:2411.13676]
HYMBA_1_5B = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    attn_window=1024,
    global_every=16,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=64,
    source="arXiv:2411.13676",
)

# mixtral-8x7b — 8 experts top-2, sliding-window attention on every layer
# (a ring-buffer decode cache) [arXiv:2401.04088]
MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attn_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)

# musicgen-medium — decoder-only over EnCodec tokens: 4 codebooks whose
# embeddings are summed and 4 parallel heads [arXiv:2306.05284]
MUSICGEN_MEDIUM = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    act="gelu",
    rope_theta=10_000.0,
    source="arXiv:2306.05284",
)

# qwen1.5-0.5b — dense with QKV bias, tied embeddings [hf:Qwen/Qwen1.5-0.5B]
QWEN1_5_0_5B = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)

# granite-20b — llama-arch code model, MQA (one KV head), GELU MLP
# [arXiv:2405.04324]
GRANITE_20B = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    source="arXiv:2405.04324",
)

# qwen2-vl-72b — the language decoder of a VLM: M-RoPE, QKV bias; the
# vision frontend is a stub of 1,024 precomputed patch embeddings
# [arXiv:2409.12191]
QWEN2_VL_72B = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend_tokens=1024,
    frontend_dim=8192,
    source="arXiv:2409.12191",
)

# gemma3-27b — 5:1 local:global attention (window 1024, every 6th layer
# global), 262k vocabulary, tied embeddings [hf:google/gemma-3-1b-pt]
GEMMA3_27B = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    attn_window=1024,
    global_every=6,
    rope_theta=1_000_000.0,
    act="gelu",
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)

# The 10 assigned architectures + the paper's own 3 models.
ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c for c in (
        GRANITE_MOE_1B_A400M, LLAMA3_8B, MAMBA2_130M, QWEN2_VL_72B,
        GEMMA3_27B, HYMBA_1_5B, QWEN1_5_0_5B, MIXTRAL_8X7B, GRANITE_20B,
        MUSICGEN_MEDIUM)
}
PAPER_ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (DIT_XL2, FLUX_LIKE, HUNYUAN_VIDEO_LIKE)
}
REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_ARCHS}
# Pure-full-attention assigned archs run long_500k only under the opt-in
# sliding-window variant: "<arch>+swa".
SUBQUADRATIC = {"mamba2-130m", "hymba-1.5b", "gemma3-27b", "mixtral-8x7b"}
SWA_FALLBACK_WINDOW = 4096


def get_config(arch: str) -> ModelConfig:
    """Resolve an ``--arch`` id, including the ``+swa`` variant suffix
    (every layer a 4,096-token sliding window)."""
    if arch.endswith("+swa"):
        base = get_config(arch[: -len("+swa")])
        return dataclasses.replace(base, attn_window=SWA_FALLBACK_WINDOW,
                                   global_every=0, name=base.name + "+swa")
    if arch not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def list_archs() -> List[str]:
    return sorted(REGISTRY)


def long_context_arch(arch: str) -> str:
    """Arch id to use for the long_500k shape: the arch itself when it is
    subquadratic or an SSM, else its ``+swa`` variant."""
    cfg = get_config(arch)
    if arch in SUBQUADRATIC or cfg.arch_type == "ssm":
        return arch
    return arch + "+swa"
