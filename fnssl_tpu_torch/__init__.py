"""PyTorch/CUDA port of fnssl_tpu, beside it in the same repository.

It mirrors ``fnssl_tpu``'s layout and names, imports neither JAX nor
``fnssl_tpu``, and runs its entry points on the first CUDA device unless
the caller asks for the CPU. The LSTM recurrence runs in CUDA kernels
written by hand for Hopper (``kernels/csrc/lstm_cluster.cu`` and
``lstm_wave.cu`` up to H = 256, ``kernels/csrc/lstm_wide.cu`` above).

float32 matrix products and cuDNN calls run in full float32, never TF32:
the input projection of every LSTM (``torch.matmul``) is held to the JAX
package's float32 results.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
__version__ = "0.1.0"
