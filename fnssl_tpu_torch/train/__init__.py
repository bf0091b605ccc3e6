"""Training (port of ``fnssl_tpu/train``): weights across the packages,
losses, the front-end, and the optimizer and steps, under the JAX
package's names; JAX's ``params_to_torch_state_dict`` is
``params_to_state_dict`` here (the port's parameters are a state dict, so
``torch_state_dict_to_params`` has no counterpart)."""
from fnssl_tpu_torch.train.convert import (
    flat_to_nested, nested_to_flat, params_to_state_dict,
    load_lightning_ckpt, load_torch_tar, save_torch_tar)
from fnssl_tpu_torch.train.losses import (
    mse_ipd_loss, ce_doa_loss, pit_mse_loss, pit_permutation)
from fnssl_tpu_torch.train.preprocess import (
    stft_features, make_fnssl_preprocess, make_ipdnet_preprocess)
from fnssl_tpu_torch.train.step import (
    TrainState, exponential_epoch_schedule, make_optimizer,
    init_train_state, make_train_step, make_eval_step)
