"""paddle.incubate (counterpart of `paddle_tpu/incubate/`): the fused
functional entries (`incubate.nn.functional`), functional
differentiation (`incubate.autograd`), `LookAhead` and `ModelAverage`
(`incubate.optimizer`) and the segment ops of `geometric`.

Each fused entry is the JAX package's chain of ops, with the port's
kernels where the JAX chain reaches a Pallas kernel: `fused_rms_norm` is
the RMSNorm kernel, `fused_multi_head_attention` and
`memory_efficient_attention` are `F.scaled_dot_product_attention` (the
flash forward, and under a gradient the dq and dk/dv kernels).
"""
from . import autograd
from . import nn
from . import optimizer
from ..geometric import segment_max, segment_mean, segment_min, segment_sum

__all__ = ['autograd', 'nn', 'optimizer', 'segment_sum', 'segment_mean',
           'segment_min', 'segment_max', 'graph_send_recv']


def graph_send_recv(x, src_index, dst_index, pool_type='sum', out_size=None,
                    name=None):
    """Pre-2.4 name of geometric.send_u_recv (upstream:
    python/paddle/incubate/operators/graph_send_recv.py)."""
    from ..geometric import send_u_recv
    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)
