"""paddle.version (counterpart of `paddle_tpu/version/__init__.py`;
upstream: the generated python/paddle/version/__init__.py). The CUDA and
cuDNN versions are those of the PyTorch build the port runs on."""
import torch

full_version = '0.1.0'
major = '0'
minor = '1'
patch = '0'
rc = '0'
commit = 'unknown'
istaged = False
with_pip = False
cuda_version = torch.version.cuda or 'False'
cudnn_version = (str(torch.backends.cudnn.version())
                 if torch.backends.cudnn.is_available() else 'False')
xpu_version = 'False'


def show():
    print(f'full_version: {full_version}')
    print(f'commit: {commit}')
    print(f'cuda: {cuda_version} (the PyTorch build\'s; kernels built by '
          f'nvcc for sm_90a at first use)')
    print(f'cudnn: {cudnn_version}')


def cuda():
    return cuda_version


def cudnn():
    return cudnn_version
