"""Typed system configuration mirroring the reference's flat SystemConfig
(reference src/util/ConfigUtils.h:23-141) with the same YAML key names
(2-level `section.key` flattening, reference ConfigUtils.cpp:24-79).

Adds device capacity fields (static table sizes for jit-stable shapes)
that have no reference analog — the reference's maps grow
unboundedly; here sizes are chosen from max_range and voxel size
(SURVEY.md §7 'hard parts' (a)).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class SystemConfig:
    # --- paths (reference ConfigUtils.h: paths group) ---
    data_directory: str = ""
    ground_truth_directory: str = ""
    output_directory: str = ""
    seq: str = "07"

    # --- player ---
    enable_viewer: bool = False          # headless build; kept for parity
    enable_statistics: bool = True
    enable_console_statistics: bool = True
    step_mode: bool = False
    auto_ground_truth_path: bool = True
    # No reference YAML key: frames per fused device
    # dispatch in the players. 0 = the reference's per-frame loop;
    # >1 routes the production players through Estimator.process_chunk
    # (the bench single-stream path) with the background chunk feeder —
    # viewer controls then act at chunk granularity.
    chunk_frames: int = 0

    # --- point_cloud ---
    voxel_size: float = 0.5
    point_stride: int = 8
    map_voxel_size: float = 0.5
    max_range: float = 100.0
    min_range: float = 0.1
    surfel_planarity_threshold: float = 0.1

    # --- feature_extraction ---
    min_plane_points: int = 5
    max_neighbors: int = 5
    max_plane_distance: float = 0.05
    collinearity_threshold: float = 0.05
    max_neighbor_distance: float = 0.5
    feature_quality_threshold: float = 0.1

    # --- odometry ---
    max_iterations: int = 4
    translation_threshold: float = 0.005
    rotation_threshold: float = 0.005
    max_correspondence_distance: float = 1.0

    # --- robust_estimation / PKO ---
    use_adaptive_m_estimator: bool = True
    loss_type: str = "huber"
    min_scale_factor: float = 0.1
    max_scale_factor: float = 10.0
    num_alpha_segments: int = 100
    truncated_threshold: float = 10.0
    gmm_components: int = 3
    gmm_sample_size: int = 100
    pko_kernel_type: str = "huber"

    # --- estimator ---
    keyframe_distance_threshold: float = 1.0
    keyframe_rotation_threshold: float = 0.3
    min_correspondence_points: int = 50
    parameter_tolerance: float = 1e-6
    function_tolerance: float = 1e-6
    use_surfel_correspondence: bool = True

    # --- keyframe ---
    # Reference sliding-window cleanup (Estimator.cpp:474-490 +
    # LidarFrame::clear_heavy_data_for_old_keyframe, LidarFrame.cpp:326-344)
    # frees raw/processed clouds and KD-trees of keyframes leaving the
    # window, KEEPING feature clouds + poses. This port's KeyframeRecord
    # only ever stores that post-cleanup payload (estimator.py:44-56), so
    # the cleanup is a no-op by construction; the key is kept for YAML
    # parity with config/kitti.yaml.
    window_size: int = 10

    # --- loop_detector ---
    enable_loop_detection: bool = True
    similarity_threshold: float = 0.3
    min_keyframe_gap: int = 50
    max_search_distance: float = 5.0
    enable_debug_output: bool = False
    # Coarse loop pre-alignment (ops/bev_align.py): the reference's loop
    # ICP searches an UNBOUNDED KD-tree (IterativeClosestPointOptimizer
    # .cpp:465-585); this grid search is bounded, so an Iris-bias yaw +
    # BEV phase-correlation initializer restores the multi-metre drift
    # envelope. No reference YAML key.
    loop_prealign: bool = True

    # --- pose_graph_optimization ---
    enable_pgo: bool = True
    pgo_backend: str = "manual"
    # No reference YAML key: scale the loop factor's noise
    # by the loop ICP's measured fine-polish RMS residual so a loop whose
    # T_rel is only cm-accurate cannot drag a mm-accurate odometry chain
    # (round-4 VERDICT weak 1). Scale 1 (reference-parity weighting) when
    # the residual sits at the surface-noise floor.
    loop_residual_weighting: bool = True
    # Innovation gate (standard SLAM chi-square-style test): if the
    # current trajectory already satisfies the measured loop T_rel within
    # the solve's own precision floor (measured 0.5-4.5 mm / <=0.9 mrad
    # on ring-scan revisits, tools/debug_loop_trel.py), the factor
    # carries no information — it is added with an inert sigma so the
    # graph records the constraint without being bent by measurement
    # noise. Real drift produces innovations far above these gates and
    # corrects at full (residual-scaled) weight. Thresholds ~3x the
    # measured solve floor.
    loop_innovation_gate_t: float = 0.012    # m
    loop_innovation_gate_r: float = 0.0015   # rad
    odometry_translation_noise: float = 1.0
    odometry_rotation_noise: float = 1.0
    loop_translation_noise: float = 1.0
    loop_rotation_noise: float = 1.0

    # --- output ---
    save_trajectory: bool = True
    trajectory_format: str = "kitti"
    print_final_errors: bool = True
    error_summary_format: str = "clean"

    # --- capacities (no reference analog: static shapes for jit) ---
    # Sharded-map deployment: batch K keyframe updates into one per-shard
    # dispatch (models/map_backend.ShardedMapBackend). K=1 matches the
    # reference's update-at-every-keyframe exactly; K=4 amortizes the
    # small-op latency floors of per-shard updates at high shard counts,
    # at the cost of lookups lagging <= K-1 keyframes behind.
    sharded_update_batch: int = 1
    scan_capacity: int = 16384           # padded feature-cloud size per scan
    map_l0_capacity: int = 262144        # L0 voxel table slots
    map_l1_capacity: int = 65536         # L1 surfel table slots
    keyframe_capacity: int = 4096        # iris DB / pose-graph capacity
    loop_cloud_capacity: int = 16384     # per-keyframe stored feature cloud

    def derived_hierarchy_factor(self) -> int:
        return 3  # reference Estimator.cpp:79 hardcodes 3

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


# Mapping from the reference's `section.key` YAML names to dataclass fields.
# Sections whose keys match field names directly are flattened as-is.
_KEY_ALIASES = {
    "keyframe.window_size": "window_size",
    "loop_detector.enable_loop_detection": "enable_loop_detection",
    "loop_detector.similarity_threshold": "similarity_threshold",
    "loop_detector.min_keyframe_gap": "min_keyframe_gap",
    "loop_detector.max_search_distance": "max_search_distance",
    "loop_detector.enable_debug_output": "enable_debug_output",
    "pose_graph_optimization.enable_pgo": "enable_pgo",
    "pose_graph_optimization.pgo_backend": "pgo_backend",
    "pose_graph_optimization.odometry_translation_noise": "odometry_translation_noise",
    "pose_graph_optimization.odometry_rotation_noise": "odometry_rotation_noise",
    "pose_graph_optimization.loop_translation_noise": "loop_translation_noise",
    "pose_graph_optimization.loop_rotation_noise": "loop_rotation_noise",
}


def _parse_scalar(text: str):
    text = text.strip()
    if text.startswith(("'", '"')) and text.endswith(("'", '"')) and len(text) >= 2:
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


def parse_flat_yaml(text: str) -> dict:
    """Hand-rolled 2-level YAML subset parser with `section.key` flattening,
    comments and quoted strings — the same grammar the reference accepts
    (ConfigUtils.cpp:24-79)."""
    out: dict = {}
    section: Optional[str] = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indented = line[0] in (" ", "\t")
        stripped = line.strip()
        if ":" not in stripped:
            continue
        key, _, value = stripped.partition(":")
        key = key.strip()
        value = value.strip()
        if not indented:
            if value == "":
                section = key
                continue
            section = None
            out[key] = _parse_scalar(value)
        else:
            if value == "":
                continue
            full = f"{section}.{key}" if section else key
            out[full] = _parse_scalar(value)
    return out


def load_config(path: str) -> SystemConfig:
    with open(path, "r") as f:
        flat = parse_flat_yaml(f.read())
    return config_from_flat(flat)


def config_from_flat(flat: dict) -> SystemConfig:
    cfg = SystemConfig()
    fields = {f.name for f in dataclasses.fields(SystemConfig)}
    updates = {}
    for full_key, value in flat.items():
        name = _KEY_ALIASES.get(full_key)
        if name is None:
            name = full_key.split(".")[-1]
        if name in fields:
            cur = getattr(cfg, name)
            if isinstance(cur, bool):
                value = bool(value)
            elif isinstance(cur, int) and not isinstance(value, bool):
                value = int(value)
            elif isinstance(cur, float):
                value = float(value)
            elif isinstance(cur, str):
                value = str(value)
            updates[name] = value
    cfg = cfg.replace(**updates)
    validate_config(cfg)
    return cfg


def validate_config(cfg: SystemConfig) -> None:
    """Sanity checks mirroring reference ConfigUtils.cpp:405-424."""
    assert cfg.voxel_size > 0, "voxel_size must be positive"
    assert cfg.map_voxel_size > 0, "map_voxel_size must be positive"
    assert cfg.point_stride >= 1, "point_stride must be >= 1"
    assert cfg.max_iterations >= 1, "max_iterations must be >= 1"
    assert cfg.max_range > cfg.min_range >= 0
    assert cfg.min_scale_factor < cfg.max_scale_factor
    assert cfg.gmm_components >= 1
    assert cfg.scan_capacity > 0 and cfg.map_l0_capacity > 0
