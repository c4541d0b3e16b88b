"""Model factory for the port's replica processes in
`test_torch_fleet_proc.py`, `test_torch_rollout.py` and
`test_torch_cuda.py` (it holds no tests).

Addressed by file path (`tests/test_torch_fleet_factory.py:tiny_llama`),
so a child interpreter loads it without the tests being a package. It
imports only torch and the port; the weights come from the fleet's
`WeightStore`, so the random initialisation here is overwritten.
"""


def tiny_llama(device='cuda', dtype='float32', **cfg):
    import sys
    leaked = [m for m in ('jax', 'paddle_tpu') if m in sys.modules]
    if leaked:
        raise RuntimeError(f'a replica of the port imported {leaked}')
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig.tiny(**cfg), device=device,
                            dtype=dtype)
