"""Typed, validated configuration with the same YAML surface as the reference.

Counterpart of ``fluid_llm_tpu/config.py``: the same dataclasses, fields,
defaults and checks, so one YAML file parses to the same values in both
packages (``tests/test_torch_config.py`` holds them equal).  The port keeps
its own copy so that it, and ``chip_smoke.py``, import nothing of the JAX
package.  Keys for features the port has not ported yet (the mesh layout:
``parallel.pipe_axis > 1``, the other axes parsed only) are accepted here
and rejected where the model is built.  :func:`check_moe` holds the MoE
keys to the JAX package's guards (``models/fluid_llm.py:52-77``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import yaml


def _sub(cls, raw: Optional[dict], name: str):
    if raw is None:
        return cls()
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"Unknown keys in {name}: {sorted(unknown)}")
    return cls(**raw)


@dataclass
class LoraConfig:
    """LoRA/DoRA adapter settings (``configs/training1.yaml:9-14``)."""

    r: int = 16
    lora_alpha: float = 64
    lora_dropout: float = 0.1
    bias: str = "none"
    use_dora: bool = True
    # peft's names of the adapted linears (q/v projections by default)
    target_modules: Sequence[str] = ("q_proj", "v_proj")


@dataclass
class PosEmbeddingConfig:
    """``configs/training1.yaml:40-44``."""

    in_emb_ln_eps: Optional[float] = None
    input_emb_layer_dropout: Optional[float] = 0.1
    # "pos"/"rope" are the reference's modes; "rope_abs" is the cache-stable
    # variant the streaming rollout needs (``rollout/streaming.py``)
    pos_embedding_type: str = "pos"  # "pos" | "rope" | "rope_abs"
    init_pos_embed: str = "normal"  # "normal" | "zero" | "scaled"

    def __post_init__(self):
        if self.pos_embedding_type not in ("pos", "rope", "rope_abs"):
            raise ValueError(f"pos_embedding_type: {self.pos_embedding_type}")
        if self.init_pos_embed not in ("normal", "zero", "scaled"):
            raise ValueError(f"init_pos_embed: {self.init_pos_embed}")


@dataclass
class EncoderConfig:
    """Patch-encoder settings (``configs/training1.yaml:47-51``)."""

    type: str = "MLP"  # "MLP" | "CNN"
    num_layers: int = 2
    hidden_dim: int = 512
    activation: str = "leakyrelu"


@dataclass
class DecoderConfig:
    """Patch-decoder settings (``configs/training1.yaml:54-61``): "MLPGNN"
    (the reference default), "MLP" (per patch) or "CNN" (Conv1d over
    tokens)."""

    type: str = "MLPGNN"  # "MLP" | "CNN" | "MLPGNN"
    gnn_dim: int = 32
    gnn_hid_dim: int = 48
    gnn_layers: int = 3
    gnn_heads: int = 1
    mlp_hid_dim: int = 512
    dropout: float = 0.0
    # Only used by type == "MLP":
    num_layers: int = 2
    hidden_dim: int = 512
    activation: str = "leakyrelu"
    zero_last_layer: bool = False


@dataclass
class TeacherForcingConfig:
    """``configs/training1.yaml:64-67``; mode selection ``src/main.py:43-59``."""

    tf_mode: str = "gen"  # "gen" | "notf"
    tf_prob: float = 0.0
    start_epoch: int = 10000


@dataclass
class ParallelConfig:
    """Device-mesh layout of the JAX package (data, tensor, FSDP, pipeline,
    sequence, ring, expert axes).  Parsed for YAML parity; the port runs on
    one device."""

    data_axis: int = -1
    model_axis: int = 1
    fsdp_axis: int = 1
    remat: bool = False
    pipe_axis: int = 1
    pipe_microbatches: int = 0
    seq_sharded_acts: bool = False
    ring_attention: bool = False
    expert_axis: int = 1


@dataclass
class MoEConfig:
    """Mixture-of-experts backbone MLPs; ``experts: 0`` is the dense model."""

    experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    router: str = "topk"  # "topk" | "expert_choice"


def check_moe(moe: MoEConfig, parallel: ParallelConfig) -> None:
    """The JAX ``FluidLLM.build``'s MoE guards (``fluid_llm.py:52-77``),
    raised where the model is built; a no-op for a dense model."""
    if moe.experts <= 0:
        return
    if parallel.pipe_axis > 1:
        raise ValueError("MoE backbones use per-layer expert banks, which the stacked pipeline "
                         "layout does not support: set parallel.pipe_axis to 1 (shard experts "
                         "via parallel.expert_axis instead)")
    if moe.router not in ("topk", "expert_choice"):
        raise ValueError(f"moe.router={moe.router!r}: use 'topk' (Switch/GShard) or "
                         "'expert_choice'")
    if not 1 <= moe.top_k <= moe.experts:
        raise ValueError(f"moe.top_k={moe.top_k} must be in [1, moe.experts={moe.experts}]: "
                         "the top-k selection loop would re-pick expert 0 with its un-zeroed "
                         "probability once every expert is taken")
    if parallel.expert_axis > 1 and moe.experts % parallel.expert_axis != 0:
        raise ValueError(f"moe.experts={moe.experts} must divide evenly over "
                         f"parallel.expert_axis={parallel.expert_axis} (the stacked (E, ...) "
                         "expert weights shard their leading axis over the expert mesh axis)")


@dataclass
class Config:
    task_name: str = "cylinder_task"

    # LLM params (``configs/training1.yaml:3-19``)
    llm_backbone: str = "facebook/opt-125m"
    llm_layers: int = -1
    llm_4bit_loading: bool = False
    freeze_llm: bool = False
    use_lora: bool = True
    lora_config: LoraConfig = field(default_factory=LoraConfig)
    half_precision: bool = True
    flash_attention: bool = True
    use_deepspeed: bool = False  # accepted for YAML parity
    use_bos_token: bool = True
    see_init_state: bool = True

    # Training params (``configs/training1.yaml:21-30``)
    batch_size: int = 8
    num_epochs: int = 260
    optimizer: str = "adamw"
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    loss_function: Sequence[str] = ("mae", "mse")
    loss_weighting: Sequence[float] = (0.1, 10.0)
    schedule_epoch: int = 50
    schedule_gamma: float = 0.75

    # Train modifications (``configs/training1.yaml:32-37``)
    pressure_weight: float = 0.1
    diff_scale_factor: float = 0.05
    loss_norm_eps: Optional[float] = 0.05
    channel_independent: bool = False
    noise: Optional[float] = None

    pos_embedding_params: PosEmbeddingConfig = field(default_factory=PosEmbeddingConfig)
    encoder_params: EncoderConfig = field(default_factory=EncoderConfig)
    decoder_params: DecoderConfig = field(default_factory=DecoderConfig)
    teacher_forcing: TeacherForcingConfig = field(default_factory=TeacherForcingConfig)

    # Dataloader params (``configs/training1.yaml:69-80``)
    autoreg_seq_len: int = 10
    val_seq_len: int = 26
    num_workers: int = 6
    load_dir: str = "synthetic"
    patch_size: Sequence[int] = (16, 16)
    stride: Sequence[int] = (16, 16)
    resolution: int = 238
    normalize_ds: bool = True
    seq_interval: int = 1
    seq_len: Optional[int] = None

    # Logging params (``configs/training1.yaml:82-87``)
    enable_wandb: bool = False
    save_on: bool = True
    save_model_each: int = 20
    checkpoint_save_path: str = "model_checkpoints"
    compile: bool = True  # accepted for YAML parity

    # additions of the JAX package, same keys
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    frozen_bf16: bool = False  # frozen backbone weights stored in bf16
    moe: MoEConfig = field(default_factory=MoEConfig)
    # absolute trajectory-step time ids instead of window-relative ones: the
    # training side of the streaming rollout (needs ``rope_abs``)
    absolute_time_ids: bool = False
    seed: int = 1234  # the reference seeds 1234 globally (``src/utils.py:23``)
    profile_dir: Optional[str] = None  # profiler trace output, if set
    val_plot_dir: Optional[str] = None
    grad_accum_steps: int = 1  # 1 = update every step

    def __post_init__(self):
        subs = (("lora_config", LoraConfig), ("pos_embedding_params", PosEmbeddingConfig),
                ("encoder_params", EncoderConfig), ("decoder_params", DecoderConfig),
                ("teacher_forcing", TeacherForcingConfig), ("parallel", ParallelConfig),
                ("moe", MoEConfig))
        for name, cls in subs:
            if isinstance(getattr(self, name), dict):
                setattr(self, name, _sub(cls, getattr(self, name), name))
        self.learning_rate = float(self.learning_rate)
        self.weight_decay = float(self.weight_decay)
        self.patch_size = tuple(int(p) for p in self.patch_size)
        self.stride = tuple(int(s) for s in self.stride)
        if self.patch_size != self.stride:
            raise ValueError("Only non-overlapping patches are supported (patch_size == stride)")
        if self.optimizer not in ("adamw", "adam", "sgd", "adafactor"):
            raise ValueError(f"Unknown optimizer {self.optimizer}")
        for fn in self.loss_function:
            if fn not in ("mse", "rmse", "mae", "mape", "smape"):
                raise ValueError(f"Unknown loss function {fn}")
        if len(self.loss_function) != len(self.loss_weighting):
            raise ValueError("loss_function and loss_weighting length mismatch")
        if self.absolute_time_ids and self.pos_embedding_params.pos_embedding_type != "rope_abs":
            raise ValueError(
                "absolute_time_ids needs pos_embedding_type: rope_abs (the learned t-table is "
                "bounded and 'rope' renormalises by batch max)")

    # -- YAML interface -----------------------------------------------------

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known - {"gen_seq_len"}  # vestigial reference key
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in raw.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
