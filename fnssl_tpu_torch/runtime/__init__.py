"""Serving (port of ``fnssl_tpu/runtime``): export artifacts and the
streaming localizer, under the JAX package's names. Importing it loads no
model code (``load_artifact`` needs none)."""
from fnssl_tpu_torch.runtime.export import (ServingModel, export_model,
                                            load_artifact)
from fnssl_tpu_torch.runtime.streaming import StreamingLocalizer
