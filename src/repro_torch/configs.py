"""Configuration records: own copies of ``repro.configs.base``'s
``ModelConfig``, ``DiffusionConfig`` and ``SpeCaConfig`` plus the
DiT-XL/2 configuration (``repro.configs.dit_xl2``).

Each record keeps the reference's fields that the port reads, with the
reference's names and defaults; the port serves class-conditional DiT
image models, so the other architecture families' fields are left out.
``dtype`` stays a string and maps to a torch dtype through
:attr:`ModelConfig.torch_dtype`.
"""
from __future__ import annotations

import dataclasses

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
    """A class-conditional DiT: AdaLN-Zero blocks of bidirectional
    attention and a GELU MLP over patch tokens."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    norm_eps: float = 1e-5
    patch_size: int = 2
    in_channels: int = 4
    num_classes: int = 0          # the label table has one more (null) row
    dtype: str = "bfloat16"
    source: str = ""              # citation for the configuration

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


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


# DiT-XL/2 — the paper's class-conditional image model [arXiv:2212.09748]:
# 28 layers, d_model 1152, 16 heads, patch 2, ImageNet classes.
DIT_XL2 = ModelConfig(
    name="dit-xl2",
    num_layers=28,
    d_model=1152,
    num_heads=16,
    d_ff=4608,
    patch_size=2,
    in_channels=4,
    num_classes=1000,
    source="arXiv:2212.09748 (paper's own model)",
)
