"""npswf — a JAX waveform-fitting framework for GPUs.

A ground-up rebuild of the NPS rg1a flash-ADC waveform analysis
(reference: mkerv/nps-waveform-analysis, a ROOT/C++ macro) as a
fixed-shape, batched, functional JAX framework:

- ``core``     — typed config, calibration bundle (ref TEST_2.C:51-85, 360-530)
- ``ops``      — batched numerical kernels: matched filter, Markov/deconvolution
                 peak search (TSpectrum::Search parity), 3x3 cluster gate,
                 cubic-spline evaluation (ref TEST_2.C:124-278, 601-828)
- ``fit``      — batched bounded Levenberg-Marquardt solver replacing
                 Minuit2/Migrad, with the two-stage retry escalation
                 (ref TEST_2.C:693-791)
- ``models``   — waveform model family (pedestal + sum A_n * ref(t - t_n))
- ``engine``   — per-event-batch pipeline under jit (ref `analyze`, TEST_2.C:540-1300)
- ``parallel`` — jax.sharding mesh / pjit sharding of the event batch,
                 halo-exchanged block sharding (replaces RDataFrame implicit MT,
                 TEST_2.C:313, 345)
- ``io``       — raw-stream decode (C++ native + numpy fallback), columnar
                 segment files, WF output writer + ordered merge
                 (ref TEST_2.C:88-122, 854-889, 1383-1432)
- ``runtime``  — streaming executor, segment resume, fit-health counters
- ``utils``    — logging, timers, profiling hooks, histograms
- ``tools``    — CLI, plotstats-style validator, parity harness
- ``golden``   — scalar numpy fp64 reference implementation used as the
                 behavioral oracle in tests
"""

__version__ = "0.1.0"

from npswf.core.config import NPSConfig  # noqa: F401
from npswf.core.calibration import CalibrationBundle  # noqa: F401
