"""Model zoo: the 10 assigned LM-family architectures on one unified stack
(the port of the JAX package's ``models``; the serving path)."""
from repro_torch.models.config import ModelConfig, LayerKind  # noqa: F401
