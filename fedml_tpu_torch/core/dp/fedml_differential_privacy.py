"""Differential-privacy orchestrator singleton (port of
``fedml_tpu.core.dp.fedml_differential_privacy``).

``enable_dp`` + ``dp_mechanism_type`` (gaussian | laplace) +
``dp_solution_type`` (``local_dp``, ``global_dp`` or ``nbafl``).  The
noise is added on the params' device from the ``dp`` generator
(``random_seed + 0xD9``, the JAX key's seed; :mod:`fedml_tpu_torch.core
.noise`), where the JAX singleton splits one key a call.
"""

from __future__ import annotations

from .. import noise

DP_SOLUTION_LOCAL = "local_dp"
DP_SOLUTION_GLOBAL = "global_dp"
DP_SOLUTION_NBAFL = "nbafl"


class FedMLDifferentialPrivacy:
    _instance = None

    @classmethod
    def get_instance(cls) -> "FedMLDifferentialPrivacy":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self.is_enabled = False
        self.solution = None
        self.frame = None
        self._noise = None

    def init(self, args):
        # reset first, so a later run without the flag in the same process
        # does not inherit the previous run's frame and noise
        self.is_enabled = False
        self.solution = None
        self.frame = None
        self._noise = None
        if args is None or not getattr(args, "enable_dp", False):
            return
        self.is_enabled = True
        sol = str(getattr(args, "dp_solution_type",
                          DP_SOLUTION_LOCAL)).strip().lower()
        self.solution = sol
        self._noise = noise.NoiseSource(
            "dp", int(getattr(args, "random_seed", 0)))
        from .frames import create_dp_frame

        self.frame = create_dp_frame(sol, args)

    def is_dp_enabled(self) -> bool:
        return self.is_enabled

    def is_local_dp_enabled(self) -> bool:
        return self.is_enabled and self.solution in (DP_SOLUTION_LOCAL,
                                                     DP_SOLUTION_NBAFL)

    def is_global_dp_enabled(self) -> bool:
        return self.is_enabled and self.solution in (DP_SOLUTION_GLOBAL,
                                                     DP_SOLUTION_NBAFL)

    def is_clipping(self) -> bool:
        return self.is_enabled and self.frame is not None and \
            self.frame.is_clipping()

    def add_local_noise(self, local_grad):
        return self.frame.add_local_noise(local_grad, self._noise)

    def add_global_noise(self, global_model):
        return self.frame.add_global_noise(global_model, self._noise)

    def global_clip(self, raw_client_list):
        return self.frame.global_clip(raw_client_list)

    def set_params_for_dp(self, raw_client_list):
        if self.frame is not None and hasattr(self.frame,
                                              "set_params_for_dp"):
            self.frame.set_params_for_dp(raw_client_list)
