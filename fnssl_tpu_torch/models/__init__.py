"""The models (port of ``fnssl_tpu/models``) as ``torch.nn.Module``s.

JAX's functional names with no torch meaning map to the modules, whose
constructors draw the weights (``init_*_params``) and whose ``forward``
is the apply (``*_apply``): ``init_lstm_params`` → ``LSTM``,
``init_linear_params`` → ``Linear``, ``init_fnssl_params`` /
``fnssl_apply`` → ``FNSSL``, ``init_mamba_params`` → ``Mamba``,
``init_retention_params`` → ``Retention``, ``init_mhsa_params`` →
``MHSA``, ``init_tconvffn_params`` → ``TConvFFN``,
``init_spatialnet_params`` / ``spatialnet_apply`` → ``SpatialNet``,
``init_ipdnet_params`` / ``ipdnet_apply`` → ``IPDnet`` and
``init_variable_ipdnet_params`` / ``variable_ipdnet_apply`` →
``VariableIPDnet``. Every other name is JAX's; as in JAX, the package's
``lstm`` is the function, and the module is ``fnssl_tpu_torch.models.lstm``.
"""
from fnssl_tpu_torch.models.lstm import lstm, LSTM, LSTMState
from fnssl_tpu_torch.models.layers import (
    Linear, linear, dropout, avg_pool_time)
from fnssl_tpu_torch.models.fnssl import (
    FNSSL, FNSSLConfig, FNSSLState, init_fnssl_state)
from fnssl_tpu_torch.models.mamba import (
    Mamba, MambaConfig, MambaState, init_mamba_state, mamba_apply,
    mamba_step)
from fnssl_tpu_torch.models.retention import (
    Retention, RetentionConfig, RetNetRelPos, retention_parallel,
    retention_chunkwise, retention_recurrent_step, rms_norm, theta_shift)
from fnssl_tpu_torch.models.attention import (
    MHSA, MHSAConfig, MHSAState, TConvFFN, TConvFFNConfig, causal_mask,
    init_mhsa_state, mhsa_apply, mhsa_apply_streaming, init_tconvffn_state,
    tconvffn_apply)
from fnssl_tpu_torch.models.spatialnet import (
    SpatialNet, SpatialNetConfig, SpatialNetState, RetentionState,
    get_causal_mask, init_spatialnet_state)
from fnssl_tpu_torch.models.ipdnet import (
    IPDnet, IPDnetConfig, IPDnetState, init_ipdnet_state, VariableIPDnet,
    VariableIPDnetConfig)
