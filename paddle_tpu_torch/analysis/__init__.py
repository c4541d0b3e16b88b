"""paddle_tpu_torch.analysis: the runtime sanitizers (counterpart of
`paddle_tpu/analysis`, whose static AST passes lint the JAX package's own
tree and are not ported)."""
from . import runtime  # noqa: F401
