"""RTI literature regression: run the HCZ Rayleigh-Taylor case and compare
spike/bubble trajectories against the digitized published curves the
reference validates with (He et al. 1999; the reference notebook's cells
0-4, both the 256² and the 2048² runs).

Port of ``multiphase_lbm_tpu/validation/rti_regression.py``:

    python -m multiphase_lbm_tpu_torch.validation.rti_regression [t_end] [N]
        [--device cuda|cpu] [--against trajectory.npz]

The run goes through :func:`..ops.hcz_fused.run_fused`, so on the card it
is the kernel ``csrc/hcz_step.cu`` at every N, on the unpadded
N × (4N + 2) lattice (the Pallas path's 8-row padding is not needed).
N = 256 keeps the config's Re 3000; N ≥ 1024 uses the literature's Re 2048,
with gravity −u_lb²/N at both.  :func:`compare`, :func:`compare_velocity`
and :func:`report` are the JAX module's.  There is no ``--archive``: the
archived trajectory is data of the JAX package, and the port never writes
there; ``--against`` reads such a trajectory (keys t, s, b, e.g.
``multiphase_lbm_tpu/validation/data/rti2048_trajectory.npz``) and prints
the run's largest spike and bubble differences from it.  The device defaults to ``cuda`` and the run refuses to start
without a visible card unless ``--device cpu`` asks for the plain path.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..io.config import lb_parameters
from ..models import hcz
from ..ops import hcz_fused
from . import rti_reference as ref


def rti_params(N: int) -> hcz.HCZParams:
    """RTI at resolution N as the literature regression runs it
    (``multiphase_lbm_tpu/validation/rti_regression.py:47-54``): Re 2048 from N = 1024 up, else the
    config's 3000; u_lb 0.04; gravity −u_lb²/N keeps g* = 1."""
    ulb = 0.04
    _, omega, _, _ = lb_parameters(ulb, N, 2048.0 if N >= 1024 else 3000.0)
    return hcz.HCZParams(omega=omega, gravity=-ulb * ulb / N, kappa=0.01)


def rti_state(N: int, device, dtype=torch.float32):
    """``(p, (f, g), fluid)`` of the RTI channel N × (4N + 2)."""
    p = rti_params(N)
    ny = 4 * N + 2
    fluid = hcz.geometry_channel(N, ny, device=device)
    state = hcz.apply_geometry(
        hcz.init_rayleigh_taylor(N, ny, p, dtype=dtype, device=device), fluid)
    return p, state, fluid


def run_regression(t_end=2.0, N=256, *, device, dtype=torch.float32,
                   log_every=0.05):
    """``(times, spikes, bubbles)``: interface heights (domain heights,
    shifted by the initial interface at 2) every ``log_every`` time units
    up to ``t_end``."""
    p, state, fluid = rti_state(N, device, dtype)
    Re = 2048.0 if N >= 1024 else 3000.0
    _, _, dx, dt = lb_parameters(0.04, N, Re)
    fluid_f32 = fluid.to(torch.float32)

    chunk = max(1, int(round(log_every / dt)))
    times, spikes, bubbles = [], [], []
    it = 0
    steps_total = int(t_end / dt)
    phi_mid = 0.5 * (p.phi_l + p.phi_g)
    ny = 4 * N + 2

    def heights(f):
        # pull only the two probe columns: x=nx/2 'spike', x=0 'bubble'
        cols = f[:, :, [N // 2, 0]].sum(dim=0).cpu().numpy()
        out = []
        for j in (0, 1):
            col = cols[1:ny - 1, j]
            below = np.nonzero(col <= phi_mid)[0]
            out.append(int(below[-1]) + 1 if below.size else 0)
        return out

    while it < steps_total:
        state = hcz_fused.run_fused(*state, fluid_f32, p, chunk)
        it += chunk
        s, b = heights(state[0])
        times.append(it * dt)
        spikes.append(s * dx - 2.0)     # shift by the initial interface
        bubbles.append(b * dx - 2.0)
    return np.array(times), np.array(spikes), np.array(bubbles)


def compare(times, heights, ref_t, ref_y):
    """Max |sim − published| over the overlapping time range."""
    ref_t = np.asarray(ref_t)
    ref_y = np.asarray(ref_y)
    lo, hi = max(times.min(), ref_t.min()), min(times.max(), ref_t.max())
    mask = (ref_t >= lo) & (ref_t <= hi)
    interp = np.interp(ref_t[mask], times, heights)
    return float(np.abs(interp - ref_y[mask]).max())


def moving_average(data, window_size=7):
    """The notebook's velocity smoother (Untitled.py cell 3)."""
    return np.convolve(data, np.ones(window_size) / window_size,
                       mode="same")


def compare_velocity(times, heights, ref_t, ref_y, window=7):
    """Velocity comparison as the notebook does it (cells 2-3):
    finite-difference both trajectories with np.gradient, smooth the
    simulated one with a 7-sample moving average, compare on the
    overlapping range.  Endpoint samples (half-filled smoothing window)
    are excluded."""
    ref_t = np.asarray(ref_t)
    ref_y = np.asarray(ref_y)
    v_sim = moving_average(np.gradient(heights, times), window)
    v_ref = np.gradient(ref_y, ref_t)
    pad = window * (times[1] - times[0])
    lo = max(times.min() + pad, ref_t.min())
    hi = min(times.max() - pad, ref_t.max())
    mask = (ref_t >= lo) & (ref_t <= hi)
    interp = np.interp(ref_t[mask], times, v_sim)
    return float(np.abs(interp - v_ref[mask]).max())


def deviations(times, spikes, bubbles, N):
    """``(spike, bubble, spike velocity, bubble velocity)`` maximum
    deviations from the published curves of resolution N."""
    if N >= 1024:
        rs_t, rs_y = ref.x_spike_2048, ref.y_spike_2048
        rb_t, rb_y = ref.x_bubble_2048, ref.y_bubble_2048
    else:
        rs_t, rs_y = ref.x_spike_256, ref.y_spike_256
        rb_t, rb_y = ref.x_bubble_256, ref.y_bubble_256
    return (compare(times, spikes, rs_t, rs_y),
            compare(times, bubbles, rb_t, rb_y),
            compare_velocity(times, spikes, rs_t, rs_y),
            compare_velocity(times, bubbles, rb_t, rb_y))


def against_archive(times, spikes, bubbles, path):
    """``(max |Δspike|, max |Δbubble|)`` of this run against an archived
    trajectory (keys t, s, b) at the archive's times inside this run."""
    d = np.load(path)
    keep = (d["t"] >= times.min()) & (d["t"] <= times.max())
    t = d["t"][keep]
    return (float(np.abs(np.interp(t, times, spikes) - d["s"][keep]).max()),
            float(np.abs(np.interp(t, times, bubbles) - d["b"][keep]).max()))


def report(times, spikes, bubbles, t_end, N):
    ds, db, dvs, dvb = deviations(times, spikes, bubbles, N)
    print(f"t_end={t_end} N={N}")
    print(f"max |spike - literature|  = {ds:.4f} (domain heights)")
    print(f"max |bubble - literature| = {db:.4f}")
    print(f"max |spike velocity  - literature| = {dvs:.4f} (heights/time)")
    print(f"max |bubble velocity - literature| = {dvb:.4f}")
    # velocities are finite differences of digitized curves: the reference
    # curve's own sampling noise is ~0.05-0.1, so the gate is looser
    ok = ds < 0.15 and db < 0.15 and dvs < 0.25 and dvb < 0.25
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = {"--device": "cuda", "--against": None}
    for key in opts:
        if key in argv:
            i = argv.index(key)
            opts[key] = argv[i + 1]
            del argv[i:i + 2]
    device, against = opts["--device"], opts["--against"]
    t_end = float(argv[0]) if len(argv) > 0 else 2.0
    N = int(argv[1]) if len(argv) > 1 else 256
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("rti_regression: no CUDA device is visible; pass --device cpu "
              "to run the plain PyTorch path on the CPU", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    times, spikes, bubbles = run_regression(t_end=t_end, N=N, device=device)
    print(f"wall time {time.perf_counter() - t0:.1f} s on {device}")
    if against:
        ds, db = against_archive(times, spikes, bubbles, against)
        print(f"against {against}: max |spike diff| = {ds:.4f}, "
              f"max |bubble diff| = {db:.4f} (domain heights)")
    return report(times, spikes, bubbles, t_end, N)


if __name__ == "__main__":
    sys.exit(main())
