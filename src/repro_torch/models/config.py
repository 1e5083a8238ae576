"""Model configuration: the fields of ``repro.models.config.ModelConfig``
that the ported families read.

Fields join as families are ported; ``validate`` rejects what the port does
not run yet instead of running it wrong.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense; others: ROADMAP (a)4
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "silu"
    qkv_bias: bool = False           # qwen2
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    logit_softcap: float = 0.0       # attention-score softcap; 0 = disabled
    sliding_window: int = 0          # 0 = all layers full attention
    global_interval: int = 0         # every Nth layer global, rest local
    dtype: str = "float32"           # param + activation dtype
    source: str = ""                 # citation (paper / model card)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def layer_is_global(self, i: int) -> bool:
        """With global_interval g, layer i is global iff (i + 1) % g == 0."""
        if self.sliding_window <= 0 or self.global_interval <= 0:
            return True
        return (i + 1) % self.global_interval == 0

    def validate(self) -> "ModelConfig":
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet "
                "(ROADMAP (a)4, other families)")
        if self.act != "silu":
            raise NotImplementedError(f"activation {self.act!r} is not ported yet")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("GQA requires n_heads % n_kv_heads == 0")
        return self
