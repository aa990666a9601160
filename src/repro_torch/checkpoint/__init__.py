"""Weight bridge: reference checkpoints and numpy leaf trees into the port."""
from repro_torch.checkpoint.bridge import load_step_dir, params_from_numpy  # noqa: F401
from repro_torch.models.transformer import init_params  # noqa: F401
