"""Signal front-end and array geometry (port of ``fnssl_tpu/core``): STFT
and its inverse, complex helpers, microphone pairs, the forgetting norm,
coordinates, GCC/SRP and the SRP-map CNN blocks, under the JAX package's
names. As in JAX, the package's ``stft`` is the function; the module is
``fnssl_tpu_torch.core.stft``."""
from fnssl_tpu_torch.core.stft import stft, istft, hann_window, num_frames
from fnssl_tpu_torch.core.complexops import (
    complex_multiplication, complex_conjugate_multiplication,
    complex_cart2polar)
from fnssl_tpu_torch.core.pairs import (
    pair_rebatch, pair_unbatch, pair_indices, num_pairs)
from fnssl_tpu_torch.core.norm import (
    forgetting_norm, forgetting_norm_streaming, offline_norm,
    ForgettingNormState, init_state)
from fnssl_tpu_torch.core.coords import cart2sph, sph2cart
from fnssl_tpu_torch.core.gcc import gcc, SRPMap
from fnssl_tpu_torch.core.convs import (
    spheric_pad, caus_conv1d, caus_conv2d, caus_conv3d, caus_cnn_block)
