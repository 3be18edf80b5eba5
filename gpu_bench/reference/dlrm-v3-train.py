"""The plain reference of `dlrm-v3-train`: the DLRM-v3 ranker's
(`dlrm-v3.py` beside this file), at this configuration's table size."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "gpu_bench_reference_dlrm_v3", os.path.join(os.path.dirname(os.path.abspath(__file__)), "dlrm-v3.py")
)
_module = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_module)
globals().update({k: v for k, v in vars(_module).items() if not k.startswith("__")})

# comparison limits of training, each set from the program's readings and
# the control's (PERF.md gives the readings)
LIMITS = {"loss_gap": 1e-5, "pred_gap": 2e-5, "grad_gap": 1e-4, "change_gap": 4e-4}
