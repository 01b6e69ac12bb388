"""Model configuration of the PyTorch port.

A copy of ``RaftStereoConfig`` with every field of the JAX package's
dataclass, so one ``config.json`` describes a model in either package.
The port runs inference (at fixed depth or with the early exit of
``exit_threshold_px``, ``exit_min_iters`` and ``exit_max_iters``) and
training of the default and the realtime architectures: every
correlation backend, the shared backbone,
the slow-fast GRU schedule, fp32 or bf16 (``mixed_precision``) with
``corr_fp32``, ``remat_gru`` with any ``remat_save`` the JAX package
accepts (models/remat.py), and the
quantized inference tier (``quant`` "int8" or "int8_mxu", the 1-byte
correlation of ``quant_corr``, calibrated ``quant_corr_scales``), the
banded encoder (``banded_encoder``, ``band_rows``: models/banded.py) and
context parallelism over a device group (``rows_shards``, ``rows_gru``,
``rows_gru_halo``, ``corr_w2_shards``: parallel/rows_sharded.py,
rows_gru.py, corr_sharded.py, under their ``rows_sharding``/
``corr_sharding`` mesh contexts).
``quant_corr_fp8`` stores the correlation as float8_e4m3fn on every
device: torch has the type on the CPU and Hopper reads it natively, so
the port has no capability fallback to int8 (the JAX package falls back
where its backend lacks fp8).
``TrainConfig`` is likewise a copy of the JAX package's.

Convention: ``hidden_dims[0]`` is the FINEST GRU level (1/2^n_downsample
resolution) and ``hidden_dims[-1]`` the coarsest, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple, Union

CORR_BACKENDS = ("reg", "alt", "reg_fused")

# Reference CLI --corr_implementation values -> backends.
_REFERENCE_CORR_ALIASES = {
    "reg": "reg",
    "alt": "alt",
    "reg_cuda": "reg_fused",
    "alt_cuda": "alt",
}


@dataclasses.dataclass(frozen=True)
class RaftStereoConfig:
    """Architecture of one RAFT-Stereo model.

    Field meanings are those of the JAX package's config, and the port
    implements every one of them, with the JAX package's validations."""

    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    context_dims: Optional[Tuple[int, ...]] = None
    n_gru_layers: int = 3
    n_downsample: int = 2
    corr_levels: int = 4
    corr_radius: int = 4
    corr_backend: str = "reg_fused"
    shared_backbone: bool = False
    slow_fast_gru: bool = False
    mixed_precision: bool = False
    corr_fp32: bool = False
    context_norm: str = "batch"
    fnet_norm: str = "instance"
    fnet_dim: int = 256
    # "auto"/"on": the ConvGRU gates go through kernels/gru_fused.py at
    # every level (the CUDA kernel on a CUDA tensor, its plain version on
    # a CPU tensor); "off": the plain conv path.
    fused_gru: str = "auto"
    # Training-only knobs: inference never reads them.  ``remat_gru``
    # recomputes each GRU iteration in the backward; ``remat_save`` names
    # what it keeps instead: any of "corr_lookup" (the lookup output),
    # "gru_gates" (every ConvGRU level's pre-activations) and
    # "motion_features" (the motion encoder's output), models/remat.py.
    # "motion_features" also keeps the lookup and the encoder's inputs
    # (the encoder runs outside the checkpoint): +5.2-5.8 GiB at
    # TrainConfig() on an H100, where JAX keeps the output alone (~1.3 GB).
    remat_gru: bool = True
    remat_save: Tuple[str, ...] = ("corr_lookup",)
    banded_encoder: bool = False
    corr_w2_shards: int = 1
    rows_shards: int = 1
    rows_gru: bool = False
    rows_gru_halo: Optional[int] = None
    sequential_fnet_pixels: Optional[int] = None
    band_rows: Optional[int] = None
    exit_threshold_px: float = 0.0
    exit_min_iters: int = 1
    exit_max_iters: Optional[int] = None
    quant: str = "off"
    quant_corr: bool = True
    quant_corr_scales: Optional[Tuple[float, ...]] = None
    quant_corr_fp8: bool = False

    def __post_init__(self):
        if self.context_dims is None:
            object.__setattr__(self, "context_dims", tuple(self.hidden_dims))
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        object.__setattr__(self, "context_dims", tuple(self.context_dims))
        object.__setattr__(self, "remat_save", tuple(self.remat_save))
        if self.quant_corr_scales is not None:
            object.__setattr__(self, "quant_corr_scales",
                               tuple(float(s) for s in self.quant_corr_scales))
        if self.corr_backend not in CORR_BACKENDS:
            alias = _REFERENCE_CORR_ALIASES.get(self.corr_backend)
            if alias is None:
                raise ValueError(
                    f"corr_backend={self.corr_backend!r} not in {CORR_BACKENDS}")
            object.__setattr__(self, "corr_backend", alias)
        if not (1 <= self.n_gru_layers <= min(len(self.hidden_dims), 3)):
            raise ValueError(
                "n_gru_layers must be in [1, min(len(hidden_dims), 3)] — the "
                "update block implements at most 3 GRU levels")
        if self.band_rows is not None and (self.band_rows < 2
                                           or self.band_rows % 2):
            raise ValueError(
                f"band_rows={self.band_rows} must be an even integer >= 2 "
                f"(stride-2 alignment of the banded encoder)")
        if self.rows_shards > 1 and self.banded_encoder:
            raise ValueError(
                "rows_shards and banded_encoder both replace the "
                "full-resolution segment's executor — enable at most one")
        if self.fused_gru not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_gru={self.fused_gru!r} not in ('auto', 'on', 'off')")
        known_saves = {"corr_lookup", "gru_gates", "motion_features"}
        unknown = set(self.remat_save) - known_saves
        if unknown:
            raise ValueError(f"remat_save names {sorted(unknown)} unknown; "
                             f"choose from {sorted(known_saves)}")
        if self.rows_gru:
            if self.rows_shards <= 1:
                raise ValueError(
                    "rows_gru extends rows_shards' context parallelism "
                    "through the GRU loop — set rows_shards > 1")
            if self.corr_w2_shards > 1:
                raise ValueError(
                    "rows_gru and corr_w2_shards>1 both reshard the "
                    "correlation volume; the combination is unsupported — "
                    "pick row sharding OR disparity-axis sharding")
        if self.rows_gru_halo is not None and (self.rows_gru_halo < 8
                                               or self.rows_gru_halo % 4):
            raise ValueError(
                f"rows_gru_halo={self.rows_gru_halo} must be a multiple of "
                f"4, >= 8 (GRU pyramid alignment; see "
                f"parallel/rows_gru.default_gru_halo)")
        if self.quant not in ("off", "int8", "int8_mxu"):
            raise ValueError(
                f"quant={self.quant!r} not in ('off', 'int8', 'int8_mxu')")
        if self.quant != "off":
            for field, why in (
                    ("rows_shards", self.rows_shards > 1),
                    ("rows_gru", self.rows_gru),
                    ("corr_w2_shards", self.corr_w2_shards > 1),
                    ("banded_encoder", self.banded_encoder)):
                if why:
                    raise ValueError(
                        f"quant={self.quant!r} is unsupported with {field}: "
                        f"the sharded/banded executors run their own "
                        f"full-precision paths")
        if self.quant_corr_scales is not None:
            if len(self.quant_corr_scales) != self.corr_levels:
                raise ValueError(
                    f"quant_corr_scales has {len(self.quant_corr_scales)} "
                    f"entries for corr_levels={self.corr_levels}")
            if any(s <= 0 for s in self.quant_corr_scales):
                raise ValueError(f"quant_corr_scales="
                                 f"{self.quant_corr_scales} must be positive")
        for norm in (self.context_norm, self.fnet_norm):
            if norm not in ("batch", "instance", "group", "none"):
                raise ValueError(f"unknown norm_fn {norm!r}")
        if self.exit_min_iters < 1:
            raise ValueError(
                f"exit_min_iters={self.exit_min_iters} must be >= 1")
        if (self.exit_max_iters is not None
                and self.exit_max_iters < self.exit_min_iters):
            raise ValueError(
                f"exit_max_iters={self.exit_max_iters} must be >= "
                f"exit_min_iters={self.exit_min_iters}")
        if self.exit_threshold_px > 0 and self.rows_gru:
            raise ValueError(
                "exit_threshold_px > 0 (adaptive early exit) is "
                "unsupported with rows_gru: the row-sharded loop executor "
                "runs a fixed-depth program (parallel/rows_gru.py)")
        if self.corr_w2_shards > 1 and self.corr_backend == "alt":
            raise ValueError(
                f"corr_w2_shards={self.corr_w2_shards} shards the 'reg' "
                f"volume and is incompatible with corr_backend='alt' (which "
                f"builds no volume) — use 'reg' or 'reg_fused'")

    # ------------------------------------------------------------------ sizes
    @property
    def downsample_factor(self) -> int:
        return 2 ** self.n_downsample

    @property
    def corr_channels(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1)

    @property
    def mask_channels(self) -> int:
        return 9 * self.downsample_factor ** 2

    # -------------------------------------------------------------- serialize
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RaftStereoConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RaftStereoConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def default(cls) -> "RaftStereoConfig":
        """The published Middlebury/ETH3D/SceneFlow architecture."""
        return cls()

    @classmethod
    def realtime(cls) -> "RaftStereoConfig":
        """The realtime architecture: one backbone for context and
        features, 2 GRU levels at 1/8 resolution on the slow-fast
        schedule, no-volume correlation, bf16."""
        return cls(shared_backbone=True, n_downsample=3, n_gru_layers=2,
                   slow_fast_gru=True, corr_backend="alt",
                   mixed_precision=True)


# ------------------------------------------------------------ request tiers
@dataclasses.dataclass(frozen=True)
class RequestTier:
    """A named accuracy/latency point on the early-exit knob, the JAX
    package's ``RequestTier`` field for field.

    A tier is a preset of (exit_threshold_px, min_iters, quant): the
    serving engine builds one program family per tier
    (serving/engine.py) and requests select one by name.
    ``exit_threshold_px <= 0`` runs the fixed-depth program;
    ``quant="int8"`` or ``"int8_mxu"`` runs the tier on the quantized
    inference path (the engine quantizes the fp32 state dict once)."""

    name: str
    exit_threshold_px: float
    min_iters: int = 1
    quant: str = "off"

    def apply(self, cfg: RaftStereoConfig) -> RaftStereoConfig:
        """The model config this tier's requests run: the base
        architecture with the early-exit and quantization knobs swapped
        in.  A tier that changes nothing maps back to the base config
        exactly, which is how the engine finds programs it can share."""
        return dataclasses.replace(
            cfg, exit_threshold_px=self.exit_threshold_px,
            exit_min_iters=self.min_iters, exit_max_iters=None,
            quant=self.quant)


# The JAX package's presets, unchanged.  Thresholds are px of mean
# |Δdisparity| per iteration at feature resolution.  "turbo" is
# interactive's exit knobs on the int8 compute path ("int8_mxu"); it fails
# the int8 drift gate in both packages (ROADMAP §C7).
REQUEST_TIERS: Dict[str, RequestTier] = {
    "interactive": RequestTier("interactive", exit_threshold_px=0.05,
                               min_iters=2),
    "balanced": RequestTier("balanced", exit_threshold_px=0.01,
                            min_iters=3),
    "quality": RequestTier("quality", exit_threshold_px=0.0, min_iters=1),
    "turbo": RequestTier("turbo", exit_threshold_px=0.05, min_iters=2,
                         quant="int8_mxu"),
}


def parse_tier(spec: Union[str, RequestTier]) -> RequestTier:
    """A tier from a preset name or an inline
    ``name:threshold[:min[:quant]]`` spec, with the JAX package's errors."""
    if isinstance(spec, RequestTier):
        return spec
    parts = str(spec).split(":")
    if len(parts) == 1:
        tier = REQUEST_TIERS.get(parts[0])
        if tier is None:
            raise ValueError(
                f"unknown tier {parts[0]!r}: use one of "
                f"{sorted(REQUEST_TIERS)} or an inline "
                f"'name:threshold_px[:min_iters[:quant]]' spec")
        return tier
    if len(parts) not in (2, 3, 4) or not parts[0]:
        raise ValueError(f"tier spec {spec!r}: expected "
                         f"'name:threshold_px[:min_iters[:quant]]'")
    try:
        threshold = float(parts[1])
        min_iters = int(parts[2]) if len(parts) >= 3 else 1
    except ValueError as e:
        raise ValueError(f"tier spec {spec!r}: expected "
                         f"'name:threshold_px[:min_iters[:quant]]'") from e
    quant = parts[3] if len(parts) == 4 else "off"
    if quant not in ("off", "int8", "int8_mxu"):
        raise ValueError(f"tier spec {spec!r}: quant {quant!r} not in "
                         f"('off', 'int8', 'int8_mxu')")
    return RequestTier(parts[0], exit_threshold_px=threshold,
                       min_iters=min_iters, quant=quant)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters, field for field the JAX package's
    ``TrainConfig`` (reference: train_stereo.py:221-247).

    The port's training loop (training/train_loop.py) reads every field;
    the augmentation and dataset fields build the loader's mixture
    (data/datasets.py ``build_training_mixture``).  ``data_parallel`` is
    the number of data-parallel processes, one per card
    (parallel/distributed.py): 0 means the world size of the process
    group, and any other value must equal it."""

    batch_size: int = 8
    train_iters: int = 22
    valid_iters: int = 32
    lr: float = 2e-4
    num_steps: int = 200_000
    wdecay: float = 1e-5
    epsilon: float = 1e-8
    clip_grad_norm: float = 1.0
    image_size: Tuple[int, int] = (320, 720)
    train_datasets: Tuple[str, ...] = ("sceneflow",)
    loss_gamma: float = 0.9
    max_flow: float = 700.0
    img_gamma: Optional[Tuple[float, float]] = None
    saturation_range: Optional[Tuple[float, float]] = None
    do_flip: Optional[str] = None
    spatial_scale: Tuple[float, float] = (-0.2, 0.4)
    noyjitter: bool = False
    device_photometric: bool = False
    # flow ships fp16 and valid uint8; the step casts both to fp32
    compact_upload: bool = True
    # the step also returns the mean |disparity update| per iteration
    gru_telemetry: bool = False
    trace_sample_rate: float = 0.0
    validation_frequency: int = 10_000
    seed: int = 1234
    data_parallel: int = 0
    anomaly_policy: bool = False
    anomaly_spike_factor: float = 0.0
    anomaly_ewma_beta: float = 0.98
    anomaly_rewind_after: int = 3
    anomaly_max_rewinds: int = 2
    checkpoint_keep: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        for k in ("image_size", "train_datasets", "img_gamma",
                  "saturation_range", "spatial_scale"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**{k: v for k, v in d.items() if k in known})
