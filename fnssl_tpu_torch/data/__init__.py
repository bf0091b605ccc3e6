"""The data path on the host (port of ``fnssl_tpu/data``): scene
simulation, the wav+pickle and compact npz formats, segmenting, batching
and the device prefetch, with the FN-SSL and IPDnet stage configs, and
IPDnet2's RealMAN reader, the LOCATA reader and the chunked-inference
segment reshapes."""
from fnssl_tpu_torch.data.params import Parameter, as_parameter
from fnssl_tpu_torch.data.arrays import (
    ArraySetup, audiowu_high_array_geometry, circular_array_geometry,
    dicit_array_setup, dualch_array_setup, linear_array_setup)
from fnssl_tpu_torch.data.vad import frame_vad, clean_silences
from fnssl_tpu_torch.data.noise import (
    NoiseDataset, gen_diffuse_noise, mix_signals)
from fnssl_tpu_torch.data.scene import (
    AcousticScene, acoustic_power, save_file, load_file)
from fnssl_tpu_torch.data.sources import (
    LibriSpeechDataset, SyntheticSpeechDataset)
from fnssl_tpu_torch.data.trajectory import RandomTrajectoryDataset
from fnssl_tpu_torch.data.segmenting import Segmenting
from fnssl_tpu_torch.data.fixed import (
    FixTrajectoryDataset, collate_segmented, save_compact)
from fnssl_tpu_torch.data.simu import (
    make_fnssl_trajectory_dataset, make_ipdnet_trajectory_dataset, generate)
from fnssl_tpu_torch.data.segments import (
    pad_segments, split_segments, merge_segments)
from fnssl_tpu_torch.data.locata import LocataDataset
from fnssl_tpu_torch.data.loader import DataLoader, prefetch_to_device
from fnssl_tpu_torch.data.realman import (
    RealData, collate_realman, search_files)
