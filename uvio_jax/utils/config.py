"""Config loader for the reference's YAML layout.

Reads the exact on-disk format of the reference
(`ov_core/src/utils/opencv_yaml_parse.h` consumer side): a master
`estimator_config.yaml` plus relative `kalibr_imu_chain.yaml`,
`kalibr_imucam_chain.yaml`, and (UVIO) `uwb_config.yaml` /
`uwb_anchors.yaml` — so a user of the reference can point this
framework at their existing `config/<dataset>/` directory unchanged.

The files are read by `parse_yaml`, a parser for the subset of YAML
those OpenCV-style config directories use (no third-party YAML library).
Conventions handled: `T_imu_cam` rows are `[R_CtoI | p_CinI]`
(converted to our `q_ItoC`, `p_IinC`); `p_UinI` is negated into the
state's `p_IinU` lever arm (`UVioManagerOptions.h:57-64` sign
convention).
"""

from __future__ import annotations

import os
import re

import numpy as np

import jax.numpy as jnp

from ..cam import EQUI, RADTAN
from ..filter.propagator import NoiseManager
from ..init.static_init import StaticInitOptions
from ..manager import CameraConfig, VioConfig
from ..math import rot_to_quat
from ..uwb_manager import AnchorConfig, UVioConfig


# YAML 1.1 plain-scalar resolution, as PyYAML's safe loader applies it
# (so `1e-15`, which has no dot, stays a string there and here)
_NULL = re.compile(r"~|null|Null|NULL|")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)([eE][-+][0-9]+)?"
    r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN)"
)


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        return bytes(tok[1:-1], "utf-8").decode("unicode_escape")
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if _NULL.fullmatch(tok):
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.fullmatch(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.fullmatch(tok):
        t = tok.replace("_", "").lower()
        return float(t.replace(".inf", "inf").replace(".nan", "nan"))
    return tok


def _flow(text: str):
    """A scalar or a (possibly nested) flow sequence `[a, [b, c]]`."""
    text = text.strip()
    if not text.startswith("["):
        return _scalar(text)
    stack, tok, quote = [[]], "", None
    for ch in text:
        if quote:
            tok += ch
            if ch == quote:
                quote = None
        elif ch in "\"'":
            tok += ch
            quote = ch
        elif ch == "[":
            stack.append([])
        elif ch in ",]":
            if tok.strip():
                stack[-1].append(_scalar(tok))
            tok = ""
            if ch == "]":
                done = stack.pop()
                if not stack:
                    raise ValueError(f"unbalanced flow sequence: {text!r}")
                stack[-1].append(done)
        else:
            tok += ch
    if len(stack) != 1 or len(stack[0]) != 1 or tok.strip():
        raise ValueError(f"malformed flow sequence: {text!r}")
    return stack[0][0]


def _split_key(content: str):
    """`key: value` -> (key, value); None when the line is no mapping entry."""
    m = re.match(r"""("[^"]*"|'[^']*'|[^'"#\[\]{}][^:]*?)\s*:(\s+|$)""", content)
    if m is None:
        return None
    return _scalar(m.group(1)), content[m.end():]


def parse_yaml(text: str):
    """Parse the YAML subset of OpenCV-style config files.

    Supported: `%` directives and `---`, `#` comments, block mappings,
    block sequences (also at the parent key's indent), flow sequences
    (nested, e.g. rows of a matrix), and plain, single- and
    double-quoted scalars resolved as YAML 1.1 does. Anything else
    (anchors, flow mappings, multi-line scalars) raises ValueError.
    """
    lines = []
    for raw in text.splitlines():
        if raw.startswith("%") or raw.strip() == "---":
            continue
        body = _strip_comment(raw).rstrip()
        if body.strip():
            if "\t" in body[: len(body) - len(body.lstrip())]:
                raise ValueError(f"tab indentation: {raw!r}")
            lines.append((len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    node, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected indentation: {lines[pos][1]!r}")
    return node


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, pos, indent):
    """Parse the block whose entries sit at `indent`; returns (node, next)."""
    if _is_item(lines[pos][1]):
        seq = []
        while pos < len(lines) and lines[pos][0] == indent and _is_item(lines[pos][1]):
            rest = lines[pos][1][1:].strip()
            pos += 1
            if rest:
                if _split_key(rest) is not None:
                    raise ValueError(f"mapping inside a sequence item: {rest!r}")
                seq.append(_flow(rest))
            elif pos < len(lines) and lines[pos][0] > indent:
                item, pos = _block(lines, pos, lines[pos][0])
                seq.append(item)
            else:
                seq.append(None)
        return seq, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        kv = _split_key(lines[pos][1])
        if kv is None:
            raise ValueError(f"expected `key: value`: {lines[pos][1]!r}")
        key, rest = kv
        pos += 1
        if rest.strip():
            out[key] = _flow(rest)
        elif pos < len(lines) and (
            lines[pos][0] > indent
            or (lines[pos][0] == indent and _is_item(lines[pos][1]))
        ):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"unexpected indentation: {lines[pos][1]!r}")
    return out, pos


def _load_yaml(path: str):
    with open(path) as f:
        return parse_yaml(f.read()) or {}


def _parse_cameras(cam_chain: dict, max_cameras: int):
    cams = []
    for i in range(max_cameras):
        key = f"cam{i}"
        if key not in cam_chain:
            break
        c = cam_chain[key]
        if "T_imu_cam" in c:
            T = np.asarray(c["T_imu_cam"], dtype=float)  # [R_CtoI | p_CinI]
            R_ItoC = T[:3, :3].T
            p_IinC = -R_ItoC @ T[:3, 3]
        else:
            T = np.asarray(c["T_cam_imu"], dtype=float)  # [R_ItoC | p_IinC]
            R_ItoC = T[:3, :3]
            p_IinC = T[:3, 3]
        q_ItoC = np.asarray(rot_to_quat(jnp.asarray(R_ItoC)))
        model = RADTAN if c.get("distortion_model", "radtan") == "radtan" else EQUI
        intr = np.concatenate(
            [np.asarray(c["intrinsics"], float), np.asarray(c["distortion_coeffs"], float)]
        )
        cams.append(
            CameraConfig(model=model, intrinsics=intr, q_ItoC=q_ItoC, p_IinC=p_IinC)
        )
    return cams


def _parse_imu_intrinsics(cfg, imu0):
    """kalibr imu-chain intrinsics -> VioConfig fields.

    Mirrors `VioManagerOptions.h:306-350`: Dw = Tw^-1, Da = Ta^-1,
    R_GYROtoIMU = R_IMUtoGYRO^T, triangular vec extraction per model,
    Tg column-wise."""
    model_s = str(imu0.get("model", "kalibr")).lower()
    model = 1 if model_s == "rpng" else 0
    out = dict(
        calib_imu_intrinsics=bool(cfg.get("calib_imu_intrinsics", False)),
        calib_imu_g_sensitivity=bool(cfg.get("calib_imu_g_sensitivity", False)),
        imu_model=model,
    )

    def mat(key):
        v = imu0.get(key)
        return None if v is None else np.asarray(v, float)

    Tw, Ta, Tg = mat("Tw"), mat("Ta"), mat("Tg")
    R_ItoG, R_ItoA = mat("R_IMUtoGYRO"), mat("R_IMUtoACC")

    def dm_vec(T):
        D = np.linalg.inv(T)
        if model == 0:  # kalibr lower triangle, column-wise
            return np.array([D[0, 0], D[1, 0], D[2, 0], D[1, 1], D[2, 1], D[2, 2]])
        return np.array([D[0, 0], D[0, 1], D[1, 1], D[0, 2], D[1, 2], D[2, 2]])

    from ..math import rot_to_quat

    if Tw is not None:
        out["imu_dw"] = dm_vec(Tw)
    if Ta is not None:
        out["imu_da"] = dm_vec(Ta)
    if Tg is not None:
        out["imu_tg"] = np.asarray(Tg).T.reshape(-1)  # column-wise 9-vector
    if R_ItoG is not None:
        out["imu_gq"] = np.asarray(rot_to_quat(jnp.asarray(R_ItoG.T)))
    if R_ItoA is not None:
        out["imu_aq"] = np.asarray(rot_to_quat(jnp.asarray(R_ItoA.T)))
    return out


def _parse_dyn_init(cfg):
    """Dynamic-init knob block (`InertialInitializerOptions.h:64-116`).

    `init_dyn_mle_max_threads` / `init_dyn_mle_max_time` are ceres
    runtime caps with no analog here (the MLE is a fixed-iteration
    jitted Gauss-Newton) and are intentionally not mapped.
    """
    from ..init.dynamic_init import DynamicInitOptions

    d = DynamicInitOptions()
    return DynamicInitOptions(
        num_pose=int(cfg.get("init_dyn_num_pose", d.num_pose)),
        max_features=int(cfg.get("init_max_features", d.max_features)),
        gn_iters=int(cfg.get("init_dyn_mle_max_iter", d.gn_iters)),
        min_deg=float(cfg.get("init_dyn_min_deg", d.min_deg)),
        min_rec_cond=float(cfg.get("init_dyn_min_rec_cond", d.min_rec_cond)),
        # shipped yamls use the short spellings (estimator_config.yaml),
        # the options header documents the long ones — accept both
        inflation_ori=float(
            cfg.get(
                "init_dyn_inflation_ori",
                cfg.get("init_dyn_inflation_orientation", d.inflation_ori),
            )
        ),
        inflation_vel=float(
            cfg.get(
                "init_dyn_inflation_vel",
                cfg.get("init_dyn_inflation_velocity", d.inflation_vel),
            )
        ),
        inflation_bg=float(
            cfg.get(
                "init_dyn_inflation_bg",
                cfg.get("init_dyn_inflation_bias_gyro", d.inflation_bg),
            )
        ),
        inflation_ba=float(
            cfg.get(
                "init_dyn_inflation_ba",
                cfg.get("init_dyn_inflation_bias_accel", d.inflation_ba),
            )
        ),
        init_bias_g=np.asarray(cfg.get("init_dyn_bias_g", [0.0, 0.0, 0.0]), float),
        init_bias_a=np.asarray(cfg.get("init_dyn_bias_a", [0.0, 0.0, 0.0]), float),
        mle_opt_calib=bool(cfg.get("init_dyn_mle_opt_calib", False)),
        gravity_mag=float(cfg.get("gravity_mag", d.gravity_mag)),
    )


def load_config(config_path: str):
    """Load `estimator_config.yaml` (or its directory) into a VioConfig
    (or UVioConfig when a uwb_config.yaml is present).

    Returns (config, extras) where extras carries values the manager
    does not consume directly (update_rate, resolution, topics...).
    """
    if os.path.isdir(config_path):
        config_path = os.path.join(config_path, "estimator_config.yaml")
    base = os.path.dirname(config_path)
    cfg = _load_yaml(config_path)

    # global print level from the config, like the reference's
    # `verbosity` yaml key (`print.h` Printer::setPrintLevel)
    if "verbosity" in cfg:
        from .logger import set_verbosity

        set_verbosity(str(cfg["verbosity"]))

    imu_chain = _load_yaml(
        os.path.join(base, cfg.get("relative_config_imu", "kalibr_imu_chain.yaml"))
    )
    cam_chain = _load_yaml(
        os.path.join(base, cfg.get("relative_config_imucam", "kalibr_imucam_chain.yaml"))
    )
    imu0 = imu_chain.get("imu0", {})
    noises = NoiseManager(
        sigma_w=float(imu0.get("gyroscope_noise_density", 1.6968e-4)),
        sigma_wb=float(imu0.get("gyroscope_random_walk", 1.9393e-5)),
        sigma_a=float(imu0.get("accelerometer_noise_density", 2.0e-3)),
        sigma_ab=float(imu0.get("accelerometer_random_walk", 3.0e-3)),
    )
    max_cams = int(cfg.get("max_cameras", 1))
    cameras = _parse_cameras(cam_chain, max_cams)
    if not cameras:
        cameras = [CameraConfig()]

    feat_rep = {
        "GLOBAL_3D": 0,
        "ANCHORED_MSCKF_INVERSE_DEPTH": 1,
        "ANCHORED_3D": 2,
        "GLOBAL_FULL_INVERSE_DEPTH": 3,
        "ANCHORED_FULL_INVERSE_DEPTH": 4,
        "ANCHORED_INVERSE_DEPTH_SINGLE": 5,
    }.get(str(cfg.get("feat_rep_slam", "ANCHORED_MSCKF_INVERSE_DEPTH")), 1)

    common = dict(
        max_clones=int(cfg.get("max_clones", 11)),
        max_slam=int(cfg.get("max_slam", 0)),
        dt_slam_delay=float(cfg.get("dt_slam_delay", 2.0)),
        feat_rep_slam=feat_rep,
        max_msckf_in_update=int(cfg.get("max_msckf_in_update", 40)),
        gravity_mag=float(cfg.get("gravity_mag", 9.81)),
        sigma_pix=float(cfg.get("up_msckf_sigma_px", 1.0)),
        chi2_mult=float(cfg.get("up_msckf_chi2_multipler", 1.0)),
        noises=noises,
        cameras=cameras,
        calib_cam_pose=bool(cfg.get("calib_cam_extrinsics", False)),
        calib_cam_intrinsics=bool(cfg.get("calib_cam_intrinsics", False)),
        calib_cam_timeoffset=bool(cfg.get("calib_cam_timeoffset", False)),
        camimu_dt=float(cfg.get("calib_camimu_dt", 0.0)),
        integration=str(cfg.get("integration", "rk4")).lower(),
        try_zupt=bool(cfg.get("try_zupt", False)),
        zupt_chi2_mult=float(cfg.get("zupt_chi2_multipler", 1.0)) or 1.0,
        zupt_max_velocity=float(cfg.get("zupt_max_velocity", 0.1)),
        zupt_noise_mult=float(cfg.get("zupt_noise_multiplier", 10.0)),
        zupt_max_disparity=float(cfg.get("zupt_max_disparity", 0.5)),
        zupt_only_at_beginning=bool(cfg.get("zupt_only_at_beginning", False)),
        # the reference hardcodes explicitly_enforce_zero_motion=false
        # (`UpdaterZeroVelocity.cpp:114`); exposed here as a yaml knob
        zupt_explicit=bool(cfg.get("zupt_explicitly_enforce_zero_motion", False)),
        init_options=StaticInitOptions(
            window_time=float(cfg.get("init_window_time", 2.0)),
            imu_thresh=float(cfg.get("init_imu_thresh", 1.5)),
            gravity_mag=float(cfg.get("gravity_mag", 9.81)),
            # extension knob (no reference yaml equivalent): false =
            # initialize during stillness instead of at motion onset
            wait_for_jerk=bool(cfg.get("init_wait_for_jerk", True)),
        ),
        init_max_disparity=float(cfg.get("init_max_disparity", 10.0)),
        use_dynamic_init=bool(cfg.get("init_dyn_use", False)),
        dyn_init_options=_parse_dyn_init(cfg),
    )
    common.update(_parse_imu_intrinsics(cfg, imu0))

    extras = {
        "num_pts": int(cfg.get("num_pts", 150)),
        "fast_threshold": float(cfg.get("fast_threshold", 20.0)),
        "grid_x": int(cfg.get("grid_x", 5)),
        "grid_y": int(cfg.get("grid_y", 5)),
        "use_klt": bool(cfg.get("use_klt", True)),
        "use_stereo": bool(cfg.get("use_stereo", False)),
        "update_rate": float(imu0.get("update_rate", 200.0)),
        "cam_timeoffset": float(cfg.get("calib_camimu_dt", 0.0)),
        "max_slam_in_update": int(cfg.get("max_slam_in_update", 25)),
    }

    # the reference's estimator_config key is `config_uwb`
    # (UVioManagerOptions.h parse_external("config_uwb", ...))
    uwb_path = os.path.join(
        base, cfg.get("config_uwb", cfg.get("relative_config_uwb", "uwb_config.yaml"))
    )
    if os.path.exists(uwb_path):
        uwb = _load_yaml(uwb_path)
        tag = uwb.get("tag0", {})
        init = uwb.get("init", {})
        anchors = []
        n_known = int(init.get("n_known_anchors", 0))
        # known anchors are expressed relative to the UAV's initial
        # position (UVioManagerOptions.h: p_AinG = pos - p_IinG0)
        p_IinG0 = np.asarray(tag.get("p_IinG0", [0.0, 0.0, 0.0]), float)
        anchors_path = os.path.join(base, "uwb_anchors.yaml")
        if n_known > 0 and os.path.exists(anchors_path):
            adata = _load_yaml(anchors_path)
            for k, a in adata.items():
                if not str(k).startswith("anchor"):
                    continue
                anchors.append(
                    AnchorConfig(
                        anchor_id=int(a["id"]),
                        p_AinG=np.asarray(a["p_AinG"], float) - p_IinG0,
                        gamma=float(a.get("const_bias", 0.0)),
                        alpha=float(a.get("dist_bias", 0.0)),
                        fix=bool(a.get("fix", False)),
                        prior_cov=np.diag(
                            [float(a.get("prior_p_AinG_cov", 0.05))] * 3
                            + [
                                float(a.get("prior_const_bias_cov", 0.2)),
                                float(a.get("prior_dist_bias_cov", 0.02)),
                            ]
                        ),
                    )
                )
        p_UinI = np.asarray(tag.get("p_UinI", [0.0, 0.0, 0.0]), float)
        out = UVioConfig(
            **common,
            max_anchors=max(8, len(anchors)),
            anchors=anchors,
            sigma_range=float(tag.get("uwb_sigma_range", 0.1)),
            uwb_chi2_mult=float(tag.get("uwb_chi2_multipler", 1.0)),
            min_dist_to_use_uwb=float(init.get("min_dist_to_use_uwb", 0.0)),
            calib_uwb_extrinsics=bool(tag.get("calib_uwb_extrinsics", False)),
            p_IinU=-p_UinI,
            p_IinU_prior_std=float(tag.get("prior_uwb_imu_cov", 0.1)) ** 0.5,
        )
        extras["n_fixed_anchors"] = int(init.get("n_fixed_anchors", 0))
        return out, extras

    return VioConfig(**common), extras
