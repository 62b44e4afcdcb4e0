"""The model module of each configuration added after ``test_benchmark.py``,
for its half-lattice diagnostics fault, which looks the module up in that
file's ``MODELS`` by configuration name."""
import pytest

LATER_MODELS = {"hcz_droplet3d": "multiphase_lbm_tpu_torch.models.hcz"}


@pytest.fixture(autouse=True)
def _later_models(request):
    models = getattr(request.module, "MODELS", None)
    if isinstance(models, dict):
        for config, module in LATER_MODELS.items():
            models.setdefault(config, module)
