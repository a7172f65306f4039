"""ionotomo_tpu — ionospheric tomography engine in JAX, run on GPUs.

A from-scratch JAX/XLA rebuild of the capabilities of
Joshuaalbert/IonoTomo (see SURVEY.md): bent-ray Fermat tracing through 3D
electron-density grids, TEC path integrals, and Bayesian tomographic
inversion, all running device-resident with solver state in HBM.

Commonly-used names are re-exported here; submodules remain the canonical
homes (core/, geometry/, models/, forward/, inversion/, data/, parallel/,
utils/, plotting/).
"""

__version__ = "0.1.0"

from .config import EngineConfig                              # noqa: F401
from .core.grids import Grid3D                                # noqa: F401
from .core import tricubic                                    # noqa: F401
from .data.datapack import DataPack                           # noqa: F401
from .data.radio_array import (RadioArray,                    # noqa: F401
                               generate_lofar_like_array)
from .data.synth import generate_example_datapack             # noqa: F401
from .data.ionosonde import (NeProbes, bottomside_probes,     # noqa: F401
                             probes_from_arrays)
from .forward.tec import (tec, dtec, dtec_paired,             # noqa: F401
                          tec_linear, tec_linear_adjoint,
                          ray_coverage)
from .forward.rm import rotation_measure, drm                 # noqa: F401
from .forward.tec import vtec_map                             # noqa: F401
from .utils.diagnostics import (phase_structure_function,     # noqa: F401
                                structure_function,
                                fit_structure_exponent)
from .geometry.fermat import (trace_rays, trace_rays_split,   # noqa: F401
                              trace_rays_stochastic)
from .geometry.rays import (RayBundle, calc_rays,             # noqa: F401
                            sample_straight_rays, make_ray_batch,
                            inner_bundle)
from .inversion.kalman import (kalman_filter,                 # noqa: F401
                               ensemble_kalman_filter,
                               initial_ensemble,
                               member_parallel_enkf)
from .inversion.online import (OnlineKalman,                  # noqa: F401
                               OnlineEnsembleKalman)
from .inversion.empirical_bayes import (log_marginal_family,  # noqa: F401
                                        fit_hyperparameters)
from .inversion.model_selection import (gcv_score,            # noqa: F401
                                        select_prior)
from .inversion.pipeline import InversionPipeline             # noqa: F401
from .inversion.priors import (GPCovariance, fit_shell_spectrum,  # noqa: F401
                               laplacian)
from .inversion.anchors import (TecAnchors,                   # noqa: F401
                                vertical_anchor_bundle,
                                anchors_from_field,
                                assimilate_probes,
                                probe_sqrt_update)
from .inversion.profile import (ProfileParams,                # noqa: F401
                                map_gauss_newton_profile,
                                chapman_log_field, log_profile_rms)
from .inversion.solution import Solution                      # noqa: F401
from .inversion import solvers                                # noqa: F401
from .inversion.solvers import map_gauss_newton_robust        # noqa: F401
from .models.chapman import (chapman_field, chapman_ne,       # noqa: F401
                             background_ne_fn,
                             altitude_field, multi_chapman_field,
                             log_parametrize, ne_from_log,
                             grid_enclosing_rays)
from .models.frozen_flow import (advect_periodic,             # noqa: F401
                                 estimate_wind,
                                 frozen_flow_sequence)
from .models.turbulence import (turbulent_log_perturbation,   # noqa: F401
                                turbulent_realizations)
from .parallel import grid_sharding, sharding                 # noqa: F401
