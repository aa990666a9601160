"""Weight bridge and checkpoints: reference checkpoints and numpy leaf trees
into the port, the port's params out in the reference's format."""
from repro_torch.checkpoint.bridge import leaves_from_params, load_step_dir, params_from_numpy  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager, TornCheckpointError  # noqa: F401
from repro_torch.models.transformer import init_params  # noqa: F401
