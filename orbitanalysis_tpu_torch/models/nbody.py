"""N-body leapfrog integrator with on-the-fly orbit detection (twin of
``orbitanalysis_tpu/models/nbody.py``).

A kick-drift-kick integrator whose state stays on the device, with the
apsis detector run between force evaluations at any cadence: the
simulation itself finds pericentre and apocentre passages, with no
snapshot written and reloaded.  Halo membership is static (a halo is a
fixed set of particle indices), so the detector needs no ID join: the
previous and current state are slot-aligned and the sign-flip compare is
elementwise.

Forces (each a ``force_fn(pos, mass, softening=, G=, box_size=)``):

- :func:`direct_forces`: the Gram form, O(N^2) memory; its two large
  products are ``torch.matmul`` in full float32 (see below);
- :func:`make_direct_force_fn` ``(use_pallas=True)``: the blocked kernel
  K14 (:func:`orbitanalysis_tpu_torch.ops.nbody.direct_forces_blocked`),
  O(N) memory;
- :func:`point_mass_forces`: a central point mass (Kepler tests);
- :func:`orbitanalysis_tpu_torch.models.pm.make_pm_force_fn` (PM, kernel
  K13 on the card) and
  :func:`orbitanalysis_tpu_torch.models.p3m.make_p3m_force_fn`.

Differences from the JAX package:

- :func:`simulate_with_tracking` is a Python loop over steps, not one
  jitted ``lax.scan``.  The detection cadence ``(step + 1) %
  detect_every`` is decided on the host from the step index; per-step
  event counts stay on the device (written into one ``[n_steps, modes]``
  tensor, no host read in the loop), and non-detect steps record 0.
- :func:`direct_forces` relies on PyTorch's default full-float32
  matrix products: TF32 (``torch.backends.cuda.matmul.allow_tf32``, or a
  float32 matmul precision other than ``'highest'``) keeps ~3 digits of
  the Gram matrix, the same fault JAX avoids with ``Precision.HIGHEST``.
  The function sets no global switch; on CUDA tensors it raises if TF32
  is on.
- The region frames sum in float64 and round once, and every division
  and root is the IEEE float32 one
  (:func:`~orbitanalysis_tpu_torch.utils.numerics.div_rn`/``sqrt_rn``),
  so the detector gives the same flags on the card and on the CPU for
  the same state.
- The detector measures each turn as ``atan2(|a x b|, a . b)``
  (:func:`turn_angle`) where the JAX package takes ``arccos(a . b)``.
  In float32 the dot of two directions less than ~3.4e-4 rad apart
  rounds to 1 and ``arccos`` gives 0, so at a fine detection cadence
  (config 4: ~1e-5 rad between detections) a turn never adds to the
  angle, a sign flip never passes ``angle > angle_cut`` and is not
  counted.  Large turns agree with the JAX package's to float32
  rounding.
- :func:`simulate_with_tracking` takes ``metrics`` (spans, counters and
  device stretches of the call); the JAX package has no such argument.
- :func:`run_tracked_simulation` checkpoints with ``torch.save`` (one
  ``step_XXXXXXXX.pt`` file a chunk: state, track(s), every per-step
  event count, the step) where the JAX package uses orbax.
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops.nbody import direct_forces_blocked
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.metrics import phase_timer
from orbitanalysis_tpu_torch.utils.numerics import (
    box_tensor,
    div_rn,
    periodic_displacement,
    sqrt_rn,
)


class NBodyState(NamedTuple):
    pos: torch.Tensor   # [N, 3]
    vel: torch.Tensor   # [N, 3]
    mass: torch.Tensor  # [N]


class TrackState(NamedTuple):
    """Slot-aligned detector state for statically assigned halo members."""

    rhat: torch.Tensor    # [H, P, 3]
    vrad: torch.Tensor    # [H, P]
    angles: torch.Tensor  # [H, P] cumulative angle since the last apsis
    counts: torch.Tensor  # [H, P] int32 apsis passages so far
    primed: torch.Tensor  # [] bool: the first detection only seeds


class OrbitNBodyConfig(NamedTuple):
    dt: float
    n_steps: int
    detect_every: int = 1
    mode: str = "pericentric"
    softening: float = 0.05
    G: float = 1.0
    box_size: Optional[float] = None
    angle_cut: float = 0.0
    # fixed detection frames; None = moving mass-weighted member frames
    centers: Optional[torch.Tensor] = None    # [H, 3]
    bulk_vels: Optional[torch.Tensor] = None  # [H, 3]


# ----------------------------------------------------------------------
# state carried across from the JAX package (host arrays)
# ----------------------------------------------------------------------

def _t(a, device, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(device) if dtype is None else t.to(device=device, dtype=dtype)


def nbody_state_from_numpy(pos, vel, mass, device="cuda") -> NBodyState:
    """An :class:`NBodyState` on ``device`` (CUDA by default) from host
    arrays, e.g. the JAX package's ``NBodyState`` fields; bit-preserving."""
    device = resolve_device(device, "nbody_state_from_numpy")
    return NBodyState(_t(pos, device), _t(vel, device), _t(mass, device))


def nbody_state_to_numpy(state: NBodyState) -> NBodyState:
    """The state's fields as host NumPy arrays (bit-preserving)."""
    return NBodyState(*(t.cpu().numpy() for t in state))


def track_state_from_numpy(rhat, vrad, angles, counts, primed,
                           device="cuda") -> TrackState:
    """A :class:`TrackState` on ``device`` (CUDA by default) from host
    arrays, e.g. the JAX package's ``TrackState`` fields."""
    device = resolve_device(device, "track_state_from_numpy")
    return TrackState(
        rhat=_t(rhat, device), vrad=_t(vrad, device),
        angles=_t(angles, device), counts=_t(counts, device, torch.int32),
        primed=_t(primed, device, torch.bool).reshape(()))


def track_state_to_numpy(track: TrackState) -> TrackState:
    """The track's fields as host NumPy arrays."""
    return TrackState(*(t.cpu().numpy() for t in track))


# ----------------------------------------------------------------------
# forces
# ----------------------------------------------------------------------

def _check_full_f32_matmul(x: torch.Tensor):
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "direct_forces needs full-float32 matrix products: TF32 keeps "
            "~3 digits of the Gram matrix.  Turn it off "
            "(torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')) or use "
            "make_direct_force_fn(use_pallas=True)")


def direct_forces(pos, mass, softening=0.05, G=1.0, box_size=None, **_):
    """Softened direct-summation gravitational acceleration ``[N, 3]``.

    Free space uses the Gram expansion ``d_ij^2 = |x_i|^2 + |x_j|^2 -
    2 x_i.x_j``: two ``torch.matmul`` products in full float32 (raises on
    CUDA tensors under TF32).  The periodic path builds the ``[N, N, 3]``
    minimum-image displacement tensor, as the JAX package does."""
    eps2 = float(softening) * float(softening)
    if box_size is None:
        _check_full_f32_matmul(pos)
        sq = torch.sum(pos * pos, dim=-1)                      # [N]
        gram = torch.matmul(pos, pos.T)                        # [N, N]
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram,
                         min=0.0) + eps2
        d2 = torch.clamp(d2, min=1e-18)
        inv_d3 = torch.rsqrt(d2) / d2                          # 1/d^3
        w = inv_d3 * mass[None, :]
        # a_i = G * (sum_j w_ij x_j - x_i sum_j w_ij)
        return G * (torch.matmul(w, pos)
                    - pos * torch.sum(w, dim=1, keepdim=True))
    dx = periodic_displacement(pos[None, :, :] - pos[:, None, :], box_size)
    d2 = torch.sum(dx * dx, dim=-1) + eps2
    inv_d3 = torch.rsqrt(d2) / d2
    w = inv_d3 * mass[None, :]
    return G * torch.sum(w[..., None] * dx, dim=1)


def make_direct_force_fn(use_pallas: bool = False):
    """A ``force_fn`` for :func:`simulate_with_tracking`.

    ``use_pallas=True`` (the JAX package's name) selects the blocked
    kernel K14 (:func:`orbitanalysis_tpu_torch.ops.nbody.
    direct_forces_blocked`): O(N) memory instead of the O(N^2) pair
    matrix, free or periodic (minimum image in the kernel).  It launches
    the CUDA kernel on CUDA tensors and raises if the kernel cannot be
    built or launched."""
    if not use_pallas:
        return direct_forces

    def force(pos, mass, softening=0.05, G=1.0, box_size=None, **_):
        return direct_forces_blocked(
            pos, mass, softening=softening, G=G,
            box_size=None if box_size is None else float(box_size))

    return force


def point_mass_forces(GM: float = 1.0, softening: float = 0.0):
    """Central point-mass field at the origin (Kepler test problems)."""

    def force(pos, mass, **_):
        r2 = torch.sum(pos * pos, dim=-1) + softening * softening
        inv_r3 = torch.rsqrt(r2) / r2
        return -GM * pos * inv_r3[:, None]

    return force


# ----------------------------------------------------------------------
# KDK leapfrog
# ----------------------------------------------------------------------

def kdk_step(state: NBodyState, acc, dt: float, force_fn: Callable,
             box_size=None, **force_kwargs):
    """One kick-drift-kick step; returns ``(new_state, new_acc)``.  The
    closing kick's acceleration is the next step's opening one, so a step
    costs one force evaluation.  With a box the drift wraps positions
    with ``torch.remainder`` (which, like ``jnp.mod``, can return the box
    itself for a tiny negative input; the CIC base index takes it modulo
    the grid)."""
    half = 0.5 * dt
    vel_half = state.vel + half * acc
    pos_new = state.pos + dt * vel_half
    if box_size is not None:
        pos_new = torch.remainder(pos_new, box_tensor(box_size, pos_new))
    acc_new = force_fn(pos_new, state.mass, box_size=box_size,
                       **force_kwargs)
    vel_new = vel_half + half * acc_new
    return NBodyState(pos=pos_new, vel=vel_new, mass=state.mass), acc_new


# ----------------------------------------------------------------------
# detection
# ----------------------------------------------------------------------

def init_track_state(n_halos: int, capacity: int, dtype=torch.float32,
                     device="cuda") -> TrackState:
    device = resolve_device(device, "init_track_state")
    return TrackState(
        rhat=torch.zeros((n_halos, capacity, 3), dtype=dtype, device=device),
        vrad=torch.zeros((n_halos, capacity), dtype=dtype, device=device),
        angles=torch.zeros((n_halos, capacity), dtype=dtype, device=device),
        counts=torch.zeros((n_halos, capacity), dtype=torch.int32,
                           device=device),
        primed=torch.zeros((), dtype=torch.bool, device=device),
    )


def _wsum(w, x):
    """``sum_p w[h, p] * x[h, p, :]`` as float64, the float32 products
    summed in float64 (the same value on every backend to float32)."""
    return torch.sum((w[..., None] * x).to(torch.float64), dim=1)


def _halo_frames(state: NBodyState, members, valid, box_size, center=None,
                 bulk=None, identity=False):
    """Region-frame quantities for statically assigned halo members.

    ``members``: ``[H, P]`` indices into the particle arrays (-1 =
    padding).  Unless given, centres and bulk velocities are the
    mass-weighted means of each halo's members (with a box, the mean of
    the minimum-image displacements from the first member, re-anchored).
    The means are float64 sums divided in float64 and rounded once.

    ``identity=True`` asserts ``members`` is ``arange(n)`` reshaped and
    replaces the member gathers by free reshapes."""
    h, p = members.shape
    if identity:
        pos = state.pos.reshape(h, p, 3)
        vel = state.vel.reshape(h, p, 3)
        w = valid.to(pos.dtype) * state.mass.reshape(h, p)
    else:
        idx = torch.clamp(members, min=0).to(torch.int64)
        pos = state.pos[idx]                       # [H, P, 3]
        vel = state.vel[idx]
        w = valid.to(pos.dtype) * state.mass[idx]
    denom = torch.clamp(torch.sum(w.to(torch.float64), dim=1), min=1e-30)

    if center is None:
        if box_size is not None:
            anchor = pos[:, :1, :]
            rel_anchor = periodic_displacement(pos - anchor, box_size)
            center = anchor[:, 0, :] + (
                _wsum(w, rel_anchor) / denom[:, None]).to(pos.dtype)
        else:
            center = (_wsum(w, pos) / denom[:, None]).to(pos.dtype)
    if bulk is None:
        bulk = (_wsum(w, vel) / denom[:, None]).to(pos.dtype)

    rel = pos - center[:, None, :]
    if box_size is not None:
        rel = periodic_displacement(rel, box_size)
    rel = rel * valid[..., None].to(pos.dtype)
    vrel = vel - bulk[:, None, :]
    r2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1] \
        + rel[..., 2] * rel[..., 2]
    radius = sqrt_rn(r2)
    inv_r = torch.where(radius > 0,
                        div_rn(1.0, torch.clamp(radius, min=1e-30)),
                        torch.zeros_like(radius))
    rhat = rel * inv_r[..., None]
    vrad = (vrel[..., 0] * rhat[..., 0] + vrel[..., 1] * rhat[..., 1]
            + vrel[..., 2] * rhat[..., 2]) * valid.to(pos.dtype)
    return rhat, vrad, radius, center, bulk


def turn_angle(a, b):
    """The angle between the directions ``a`` and ``b`` (``[..., 3]``,
    unit or zero), as ``atan2(|a x b|, a . b)``.  The cross product is
    taken as ``a x (b - a)``, the same vector, whose digits survive a
    small turn: ``b - a`` is nearly exact there, where each product of
    ``a x b`` rounds to ~6e-8 of 1.  float32 ``acos(a . b)`` rounds every
    turn below ~3.4e-4 rad to 0, since ``a . b`` rounds to 1."""
    d = b - a
    cx = a[..., 1] * d[..., 2] - a[..., 2] * d[..., 1]
    cy = a[..., 2] * d[..., 0] - a[..., 0] * d[..., 2]
    cz = a[..., 0] * d[..., 1] - a[..., 1] * d[..., 0]
    sin = torch.sqrt(cx * cx + cy * cy + cz * cz)
    cos = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return torch.atan2(sin, cos)


def _apsis_update(track, rhat, vrad, valid, mode, angle_cut):
    """Mode-specific half of the static detector: sign flip and angle
    accumulate/reset against fresh region frames (split out so
    ``mode='both'`` computes the frames once and runs this twice)."""
    zero = torch.zeros((), dtype=rhat.dtype, device=rhat.device)
    dtheta = torch.where(valid, turn_angle(track.rhat, rhat), zero)
    if mode == "pericentric":
        flip = (track.vrad < 0) & (vrad > 0)
    else:
        flip = (track.vrad > 0) & (vrad < 0)
    primed = track.primed
    apsis = valid & flip & primed

    angle_acc = track.angles + torch.where(primed, dtheta, zero)
    hit = apsis & (angle_acc > angle_cut)
    counts = track.counts + hit.to(track.counts.dtype)
    angles = torch.where(apsis, zero, angle_acc)
    new_track = TrackState(
        rhat=rhat, vrad=vrad, angles=angles, counts=counts,
        primed=torch.ones((), dtype=torch.bool, device=rhat.device))
    return new_track, apsis


def detect_apsides_static(track: TrackState, state: NBodyState, members,
                          mode: str = "pericentric", box_size=None,
                          angle_cut: float = 0.0, center=None, bulk_vel=None,
                          identity=False):
    """Slot-aligned apsis update (no ID join: membership is static).
    Returns ``(new_track, (apsis [H, P] bool, radius, center, bulk))``."""
    members = torch.as_tensor(members, device=state.pos.device)
    valid = members >= 0
    rhat, vrad, radius, center, bulk = _halo_frames(
        state, members, valid, box_size, center=center, bulk=bulk_vel,
        identity=identity)
    new_track, apsis = _apsis_update(track, rhat, vrad, valid, mode,
                                     angle_cut)
    return new_track, (apsis, radius, center, bulk)


# ----------------------------------------------------------------------
# the simulate + track loop
# ----------------------------------------------------------------------

def _num(v):
    """Array-valued config numbers (NumPy or torch scalars, or vectors)
    -> Python floats (tuples for vectors)."""
    if v is None or isinstance(v, (int, float)):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    a = np.asarray(v)
    return float(a) if a.ndim == 0 else tuple(float(x) for x in a)


class _CallPhases:
    """The spans and counters of one :func:`simulate_with_tracking` call:
    :func:`~orbitanalysis_tpu_torch.utils.metrics.phase_timer` spans into
    ``metrics`` (the profiler's ranges alone with None) and, on CUDA with
    ``metrics``, each phase's stretch of the device stream between CUDA
    timing events, read once by :meth:`close`."""

    def __init__(self, metrics, device):
        self._out = metrics
        self._clock = metrics is not None and device.type == "cuda"
        self._events = []

    @contextlib.contextmanager
    def __call__(self, name, counter=None, device_key=None):
        with phase_timer(self._out, name):
            if self._clock and device_key is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._events.append((device_key, start, end))
            else:
                yield
        if counter is not None and self._out is not None:
            self._out[counter] = self._out.get(counter, 0) + 1

    def close(self):
        """Add the device stretches into ``metrics``: one wait, on the
        last event recorded, which completes every earlier one."""
        if self._events:
            self._events[-1][2].synchronize()
        for key, start, end in self._events:
            self._out[key] = self._out.get(key, 0.0) + start.elapsed_time(
                end) * 1e-3


def simulate_with_tracking(state: NBodyState, members,
                           config: OrbitNBodyConfig,
                           force_fn: Callable = direct_forces,
                           track: Optional[TrackState] = None,
                           step_offset: int = 0,
                           identity: Optional[bool] = None,
                           metrics: Optional[dict] = None):
    """Run ``n_steps`` of KDK with apsis detection every ``detect_every``
    steps.

    Returns ``(final NBodyState, final TrackState, events)``: per-step
    total event counts (``[n_steps]`` int32, 0 on steps without a
    detection) on the state's device.  ``mode='both'`` tracks pericentres
    and apocentres from one frame computation a detection: the track is
    a ``(peri, apo)`` pair and the counts ``[n_steps, 2]``.

    ``track``/``step_offset`` resume a run mid-stream
    (:func:`run_tracked_simulation`): ``step_offset`` keeps the cadence's
    phase across chunks.  ``identity`` (members are ``arange(n)``, every
    particle tracked in order: the frames skip their gathers) is detected
    only for a host NumPy ``members``; pass ``identity=True`` for device
    tensors.  ``members`` is ``[H, P]`` (NumPy or a tensor).

    ``metrics`` (a dict, as :func:`~orbitanalysis_tpu_torch.utils.
    metrics.phase_timer` takes) gathers the call's host seconds, adding
    to what it holds: ``step_s`` (``sim.step``: each step's enqueue, the
    KDK step and its detection), ``force_s`` (``sim.force``) and
    ``detect_s`` (``sim.detect``), the counters ``force_evals`` and
    ``detections`` (the opening force evaluation and, on a fresh track,
    the seeding detection included) and, on CUDA tensors, the device
    stretches ``force_device_s`` and ``detect_device_s`` (CUDA timing
    events, read once at the end of the call).  ``force_fn`` is then
    called with ``metrics=`` too (the PM force adds its ``deposit_s``,
    ``solve_s``, ``interp_s``, ``deposited`` and ``interp_stream``).
    Without it no timing event is recorded and nothing waits for the
    device."""
    if config.mode not in ("pericentric", "apocentric", "both"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    both = config.mode == "both"
    modes = ("pericentric", "apocentric") if both else (config.mode,)
    if track is not None:
        n_tr = 1 if isinstance(track, TrackState) else len(track)
        if n_tr != len(modes):
            raise ValueError(
                f"mode={config.mode!r} expects "
                f"{'a (peri, apo) pair' if both else 'a single'}"
                f" TrackState to resume from, got {n_tr}"
            )
    dt, soft, G = _num(config.dt), _num(config.softening), _num(config.G)
    box, cut = _num(config.box_size), _num(config.angle_cut)
    n_steps, every = int(config.n_steps), int(config.detect_every)
    dev = state.pos.device
    h, p = members.shape
    if identity is None:
        identity = bool(
            isinstance(members, np.ndarray)
            and h * p == state.pos.shape[0]
            and np.array_equal(members.ravel(),
                               np.arange(h * p, dtype=members.dtype)))
    members = torch.as_tensor(members, device=dev)
    valid = members >= 0

    def as_dev(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    centers, bulks = as_dev(config.centers), as_dev(config.bulk_vels)

    phases = _CallPhases(metrics, dev)
    extra = {} if metrics is None else {"metrics": metrics}

    def force(pos, mass, **kw):
        with phases("sim.force", "force_evals", "force_device_s"):
            return force_fn(pos, mass, **kw, **extra)

    def detect(trs, st):
        with phases("sim.detect", "detections", "detect_device_s"):
            rhat, vrad, _r, _c, _b = _halo_frames(
                st, members, valid, box, center=centers, bulk=bulks,
                identity=identity)
            outs, evs = [], []
            for m, tr in zip(modes, trs):
                tr2, apsis = _apsis_update(tr, rhat, vrad, valid, m, cut)
                outs.append(tr2)
                evs.append(torch.sum(apsis, dtype=torch.int32))
            return tuple(outs), torch.stack(evs)

    acc = force(state.pos, state.mass, softening=soft, G=G, box_size=box)
    if track is None:
        trs = tuple(init_track_state(h, p, dtype=state.pos.dtype, device=dev)
                    for _ in modes)
        # seed from the initial conditions, so the first interval can
        # already catch a sign flip
        trs, _ = detect(trs, state)
    else:
        trs = (track,) if isinstance(track, TrackState) else tuple(track)
    events = torch.zeros((n_steps, len(modes)), dtype=torch.int32, device=dev)
    st = state
    for k in range(n_steps):
        with phases("sim.step"):
            st, acc = kdk_step(st, acc, dt, force, box_size=box,
                               softening=soft, G=G)
            if (int(step_offset) + k + 1) % every == 0:
                trs, events[k] = detect(trs, st)
    phases.close()
    if both:
        return st, trs, events
    return st, trs[0], events[:, 0]


def _track_dicts(track):
    """A track (or a ``(peri, apo)`` pair) as CPU tensor dictionaries."""
    if isinstance(track, TrackState):
        return {k: v.cpu() for k, v in track._asdict().items()}
    return [_track_dicts(t) for t in track]


def _restore_track(obj, device):
    def one(d):
        d = {k: v.to(device) for k, v in d.items()}
        d["primed"] = torch.ones((), dtype=torch.bool, device=device)
        return TrackState(**d)

    return tuple(one(d) for d in obj) if isinstance(obj, list) else one(obj)


def _latest_checkpoint(ck_dir):
    steps = []
    for path in glob.glob(os.path.join(ck_dir, "step_*.pt")):
        name = os.path.basename(path)[5:-3]
        if name.isdigit():
            steps.append(int(name))
    return max(steps) if steps else None


def run_tracked_simulation(state: NBodyState, members,
                           config: OrbitNBodyConfig,
                           force_fn: Callable = direct_forces,
                           checkpoint_dir: Optional[str] = None,
                           checkpoint_every: Optional[int] = None,
                           resume: bool = False):
    """Chunked driver around :func:`simulate_with_tracking` with durable
    checkpoints.

    The run goes in chunks of ``checkpoint_every`` steps; after each, the
    whole resumable state (particles, detector track or pair, every
    per-step event count so far, the step) goes to
    ``checkpoint_dir/step_XXXXXXXX.pt`` (``torch.save``, written to a
    temporary name, synced to disk and renamed).  ``resume=True`` continues from the
    latest step saved; the resumed track is primed.  The format is the
    port's own (the JAX package writes orbax checkpoints)."""
    if checkpoint_dir is None or checkpoint_every is None:
        return simulate_with_tracking(state, members, config, force_fn)
    os.makedirs(checkpoint_dir, exist_ok=True)
    dev = state.pos.device
    step_done, track, events = 0, None, []
    if resume:
        latest = _latest_checkpoint(checkpoint_dir)
        if latest is not None:
            saved = torch.load(
                os.path.join(checkpoint_dir, f"step_{latest:08d}.pt"),
                map_location="cpu", weights_only=True)
            state = NBodyState(**{k: v.to(dev)
                                  for k, v in saved["state"].items()})
            track = _restore_track(saved["track"], dev)
            events = [saved["events"].to(dev)]
            step_done = int(saved["step"])
    while step_done < config.n_steps:
        n = min(checkpoint_every, config.n_steps - step_done)
        state, track, ev = simulate_with_tracking(
            state, members, config._replace(n_steps=n), force_fn,
            track=track, step_offset=step_done)
        events.append(ev)
        step_done += n
        path = os.path.join(checkpoint_dir, f"step_{step_done:08d}.pt")
        with open(path + ".tmp", "wb") as f:
            torch.save({
                "state": {k: v.cpu() for k, v in state._asdict().items()},
                "track": _track_dicts(track),
                "events": torch.cat(events).cpu(),
                "step": step_done,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)
    return state, track, torch.cat(events)


def total_energy(state: NBodyState, softening=0.05, G=1.0, box_size=None):
    """Kinetic plus pairwise potential energy (integrator validation)."""
    ke = 0.5 * torch.sum(state.mass * torch.sum(state.vel ** 2, dim=-1))
    dx = state.pos[None, :, :] - state.pos[:, None, :]
    if box_size is not None:
        dx = periodic_displacement(dx, box_size)
    d2 = torch.sum(dx * dx, dim=-1) + softening * softening
    inv_d = torch.rsqrt(d2)
    mm = state.mass[:, None] * state.mass[None, :]
    off = 1.0 - torch.eye(state.pos.shape[0], dtype=state.pos.dtype,
                          device=state.pos.device)
    pe = -0.5 * G * torch.sum(mm * inv_d * off)
    return ke + pe
