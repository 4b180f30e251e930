"""Latency / energy lookup table (MNSIM-2.0-style behaviour level).

The paper keeps "a look-up table for the storage of the latency and power
parameters associated with basic hardware behaviors", extended with epitome
entries (IFAT/IFRT/OFAT lookups, joint module).  MNSIM's exact constants are
not published in the paper, so the two FP32 anchor rows of Table 1
(ResNet-50: 139.8 ms / 214.0 mJ; EPIM-ResNet50 1024x256: 167.7 ms /
194.8 mJ) calibrate the two free scale factors; everything else is
structural.  See `calibrate()`.

Units: seconds and joules per *event*; events are counted by simulator.py.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TinyCalibration:
    """Latency coefficients for the tiny (8, 8)-crossbar simulator.

    These are the JAX reference's data (``repro.pim.tables``), copied as
    they are so that a plan searched or legalized by either package is the
    same plan, bit for bit.  The reference fitted them to wall times of its
    own tiny-resnet forwards (dense, and the auto-planned kernel x q3
    design, batch 2 at 16 x 16) on a CPU host running its Pallas kernels in
    interpret mode: 0.521 ms and 2.524 ms.  They are not times of this
    port or of any card; ``simulator.calibrate_tiny_coefficients`` refits
    them on the card and returns the fit without storing it.  The model
    is

      latency = A * R + B * V   with   A, B >= 0

    and its non-negative projection kept the round-event term only (B = 0).
    Energy coefficients are not touched: wall time measures latency only.
    """
    A: float = 5.3825e-07        # s per round event (the reference's fit)
    B: float = 0.0               # s per buffer element (non-neg projection)
    measured_dense_s: float = 5.206e-4
    measured_epitome_s: float = 2.5236e-3
    batch: int = 2
    hw: int = 16
    method: str = ("calibrate_tiny_coefficients @ 2026-07-31, "
                   "repo CI container (CPU interpret mode)")


TINY_CALIBRATION = TinyCalibration()


@dataclasses.dataclass
class HardwareLUT:
    # --- per crossbar activation round (word-line pulse + sense) -----------
    t_round: float = 50e-9       # DAC setup + xbar read + S&H (per round)
    t_adc: float = 1e-9          # ADC conversion, per 8 columns (shared ADC)
    adc_share: int = 8           # columns per ADC
    # --- index tables (the paper's added datapath; §4.3) --------------------
    t_ifat: float = 1e-9         # IFAT lookup per round
    t_ifrt: float = 1e-9         # IFRT row-select per round
    t_ofat: float = 2e-9         # OFAT + joint module per output round
    # --- energy -------------------------------------------------------------
    e_round_row: float = 0.05e-12   # DAC + word line, per active row per round
    e_adc: float = 2e-12            # per column conversion
    e_buf_rd: float = 0.05e-12      # input buffer read, per element
    e_buf_wr: float = 0.20e-12      # output buffer write, per element (costly)
    e_table: float = 0.01e-12       # IFAT/IFRT/OFAT lookup, per round
    e_static_xb: float = 0.0        # leakage/peripheral per crossbar per inference
    # --- calibration scale factors (solved by calibrate()) ------------------
    lat_scale: float = 1.0
    en_scale: float = 1.0
