"""RealMAN real-recording dataset, IPDnet2's training data (port of
``fnssl_tpu/data/realman.py``, draw for draw).

Parity: IPDnet2/RecordData.py:13-322 ``RealData``: on-the-fly mode loads
per-channel recordings for a chosen mic subset, crops a random 4 s
segment (seeded per item), reads the 10 Hz angle/distance CSV streams,
computes the direct-path energy VAD, mixes a second source with the
reference's four overlap modes (+30% single-source), and adds recorded
noise at a uniform SNR; offline mode reads pre-generated wav + npy
target/vad/distance files. All randomness flows through the per-item
seed, so an item is the same numbers in both packages.

The targets CSV (columns ``filename``, ``angle(°)``, ``distance``) is read
with the standard ``csv`` module, not pandas: a static source holds one
number a column, a moving source the quoted, comma-separated 10 Hz
streams of its angles and distances.

File layout (configurable extension; RealMAN ships flac, which needs
``soundfile``): <data_dir>/<filename from CSV> with channels
<stem>_CH<i>.<ext>, a direct-path copy under a sibling 'dp_speech' tree,
and noise recordings with the same channel convention.

Decoded-sample cache (``cache_dir``): the first access to each file
decodes it once into an ``.npy`` (atomic tmp+rename, safe across loader
threads) and every later access memory-maps it. The cached array is the
raw decode at the source rate (float64, what ``read_audio`` returns), so
crop, energy VAD, overlap masks and SNR mixing under the same per-item
seed are bit-for-bit those of uncached mode.
"""
from __future__ import annotations

import csv
import os
import threading

import numpy as np
import scipy.signal

from fnssl_tpu_torch.data.arrays import audiowu_high_array_geometry
from fnssl_tpu_torch.physics.targets import energy_vad
from fnssl_tpu_torch.utils.audio_io import read_audio


def search_files(dir_path: str, flag: str) -> list[str]:
    out = []
    for root, _, files in os.walk(dir_path):
        out += [os.path.join(root, f) for f in files if f.endswith(flag)]
    return sorted(out)


class RealData:
    def __init__(self, data_dir: str, target_dir, noise_dir: str,
                 input_fs: int = 16000,
                 use_mic_id=(1, 2, 3, 4, 5, 6, 7, 8, 0),
                 target_fs: int = 16000, snr=(-10, 15),
                 wav_use_len: float = 4.0, on_the_fly: bool = True,
                 is_variable_array: bool = False, max_source: int = 1,
                 ext: str = "flac", dp_dirname: str = "dp_speech",
                 ma_dirname: str = "ma_speech",
                 cache_dir: str | None = None):
        self.cache_dir = cache_dir
        self._fs_index: dict[str, int] = {}
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
        self.ext = ext
        self.dp_dirname, self.ma_dirname = dp_dirname, ma_dirname
        self.data_paths: list[str] = []
        self.on_the_fly = on_the_fly
        self.target_fs = target_fs
        self.input_fs = input_fs
        self.pos_mics = audiowu_high_array_geometry()
        self.use_mic_id = list(use_mic_id)
        self.is_variable_array = is_variable_array
        self.max_source = max_source
        if on_the_fly:
            if isinstance(target_dir, str):
                target_dir = [target_dir]
            self._csv_keys: dict[str, str] = {}
            # filename -> (angle text, distance text); a later row of the
            # same filename is not read (pandas' .at would return a Series)
            self.all_targets: dict[str, tuple[str, str]] = {}
            for d in target_dir:
                with open(d, newline="", encoding="utf-8") as f:
                    rows = list(csv.DictReader(f))
                for row in rows:
                    name = row["filename"]
                    p = os.path.join(data_dir, name)
                    self.data_paths.append(p)
                    self._csv_keys[p] = name
                    self.all_targets.setdefault(
                        name, (row["angle(°)"], row["distance"]))
            self.SNR = snr
            self.wav_use_len = wav_use_len
            self.target_len = int(wav_use_len * 10)
            self.noise_paths = search_files(noise_dir, f"_CH0.{ext}")
        else:
            self.data_paths = search_files(data_dir, ".wav")

    def __len__(self):
        return len(self.data_paths)

    # --- mic-subset selection (RecordData.py:80-103) ---

    def select_mic_array_no_circle(self, rng):
        blocked = ({0, 2, 4, 6, 24}, {1, 3, 5, 7, 24})
        while True:
            n = int(rng.integers(2, 9))
            ids = list(rng.choice(np.arange(28), n, replace=False))
            if set(ids) not in blocked:
                return ids, self.pos_mics[ids]

    def select_mic_array_9mic(self, rng):
        n = int(rng.integers(2, 9))
        ids = list(rng.choice(np.arange(27), n, replace=False))
        return ids, self.pos_mics[ids]

    # --- IO helpers ---

    def _read_cached(self, path: str) -> tuple[np.ndarray, int]:
        """read_audio through the decoded-sample cache: first access
        decodes into <cache_dir>/<flattened-path>.npy with the sample
        rate in a ``.fs`` sidecar; later accesses mmap. Both files land
        by atomic rename with the .npy last, so a reader that sees the
        .npy always finds the sidecar. Lookups are two stats, no
        directory listing."""
        if self.cache_dir is None:
            return read_audio(path)
        base = os.path.join(
            self.cache_dir,
            os.path.normpath(path).replace(os.sep, "__").lstrip("_"))
        npy, fsf = base + ".npy", base + ".fs"
        if os.path.exists(npy):
            fs = self._fs_index.get(npy)
            if fs is None:
                with open(fsf) as f:
                    fs = int(f.read())
                self._fs_index[npy] = fs
            return np.load(npy, mmap_mode="r"), fs
        data, fs = read_audio(path)
        # unique per writer: two loader threads of one process may decode
        # the same channel at once
        uniq = f"{os.getpid()}.{threading.get_ident()}"
        tmpf = f"{fsf}.{uniq}.tmp"
        with open(tmpf, "w") as f:
            f.write(str(int(fs)))
        os.replace(tmpf, fsf)
        tmp = f"{npy}.{uniq}.tmp.npy"
        np.save(tmp, data)
        os.replace(tmp, npy)
        self._fs_index[npy] = int(fs)
        return data, fs

    def _ch_path(self, sig_path: str, mic: int) -> str:
        return sig_path.replace(f".{self.ext}", f"_CH{mic}.{self.ext}")

    def _load_channels(self, sig_path: str, mic_ids) -> np.ndarray:
        chans = []
        for i in mic_ids:
            s, fs = self._read_cached(self._ch_path(sig_path, i))
            chans.append(s)
        sig = np.stack(chans, axis=-1)
        if fs != self.target_fs:
            sig = scipy.signal.resample(
                sig, int(sig.shape[0] * self.target_fs / fs))
        return sig

    def _crop_probe(self, sig_path: str, mic_ids):
        """Cached-mode fast path probe: mmap the first channel; when no
        resample is needed, the crop window is sliced out of each
        channel's mmap before stacking. Returns (length, usable); usable
        False takes the full _load_channels path (the same rng draws
        either way)."""
        if self.cache_dir is None:
            return 0, False
        s0, fs0 = self._read_cached(self._ch_path(sig_path, mic_ids[0]))
        return s0.shape[0], fs0 == self.target_fs

    def _load_channels_window(self, sig_path: str, mic_ids, start: int,
                              n: int) -> np.ndarray:
        return np.stack(
            [np.asarray(self._read_cached(
                self._ch_path(sig_path, i))[0][start: start + n])
             for i in mic_ids], axis=-1)

    @staticmethod
    def get_snr_coeff(wav1, wav2, target_db):
        ae1 = np.mean(wav1 ** 2)
        ae2 = np.mean(wav2 ** 2)
        if ae1 == 0 or ae2 == 0 or not np.isfinite(ae1) \
                or not np.isfinite(ae2):
            return 1.0
        return float(np.sqrt(ae1 / ae2 * 10 ** (-target_db / 10)))

    def _targets_for(self, sig_path, start_frame: int):
        """10 Hz angle/distance streams for a crop starting at
        ``start_frame`` (10 Hz units)."""
        angle, distance = self.all_targets[self._csv_keys[sig_path]]
        tl = self.target_len
        targets = np.zeros((tl, 1), np.float32)
        distances = np.zeros((tl, 1), np.float32)
        if "," in angle:                 # moving: streams
            ang = np.array([int(float(a)) for a in angle.split(",")],
                           np.float32)
            dis = np.array([float(d) for d in distance.split(",")],
                           np.float32)
            ang = ang[start_frame: start_frame + tl]
            dis = dis[start_frame: start_frame + tl]
            n = min(len(ang), tl)
            targets[:n, 0] = ang[:n]
            distances[:n, 0] = dis[:n]
        else:                            # static source
            dist = float(distance)
            if dist < -100:
                dist = 1.0
            targets[:, 0] = float(angle)
            distances[:, 0] = dist
        return targets, distances

    def __getitem__(self, idx_seed):
        idx, seed = idx_seed if isinstance(idx_seed, tuple) else (idx_seed,
                                                                  0)
        rng = np.random.default_rng(np.random.PCG64(seed))
        if not self.on_the_fly:
            sig_path = self.data_paths[idx]
            sig, _ = read_audio(sig_path)
            d = os.path.dirname(sig_path)
            fid = os.path.basename(sig_path).replace(".wav", ".npy")
            targets = np.load(os.path.join(d, "targets_" + fid))
            distances = np.load(os.path.join(d, "dis_" + fid))
            vad = np.load(os.path.join(d, "vad_" + fid))
            topo = self.pos_mics[self.use_mic_id]
            return (sig, targets.astype(np.float32),
                    vad.astype(np.float32), topo,
                    distances.astype(np.float32), sig_path)

        paths = [self.data_paths[idx]]
        if self.max_source > 1:
            idx2 = int(rng.choice(
                [i for i in range(len(self.data_paths)) if i != idx]))
            paths.append(self.data_paths[idx2])
        mic_ids = (self.select_mic_array_9mic(rng)[0]
                   if self.is_variable_array else self.use_mic_id)

        nsample = int(self.wav_use_len * self.target_fs)
        sigs, vads, targets_l, dist_l = [], [], [], []
        for sig_path in paths:
            # direct-path sibling tree (works for relative paths too)
            dp_path = sig_path.replace(self.ma_dirname + os.sep,
                                       self.dp_dirname + os.sep, 1)
            dp_sig, _ = self._read_cached(dp_path)
            length, fast = self._crop_probe(sig_path, mic_ids)
            if fast and length >= 5 * self.target_fs:
                # same single rng draw as the slow branch below
                start = int(rng.integers(0, length - nsample))
                dp = dp_sig[start: start + nsample]
                sig = self._load_channels_window(sig_path, mic_ids,
                                                 start, nsample)
            else:
                sig = self._load_channels(sig_path, mic_ids)
                if sig.shape[0] < 5 * self.target_fs:  # pad short files
                    start = 0
                    padded = np.zeros((nsample, sig.shape[1]))
                    n = min(nsample, sig.shape[0])
                    padded[:n] = sig[:n]
                    sig = padded
                    dp = np.zeros(nsample)
                    dp[: min(nsample, len(dp_sig))] = dp_sig[:nsample]
                else:
                    start = int(rng.integers(0, sig.shape[0] - nsample))
                    dp = dp_sig[start: start + nsample]
                    sig = sig[start: start + nsample]
            vad = np.zeros((self.target_len, 1), np.float32)
            ev = energy_vad(dp, self.target_fs)
            vad[: min(len(ev), self.target_len), 0] = \
                ev[: self.target_len]
            tgt, dis = self._targets_for(
                sig_path, start // (self.target_fs // 10))
            sigs.append(sig)
            vads.append(vad)
            targets_l.append(tgt)
            dist_l.append(dis)

        if self.max_source > 1:
            self._apply_overlap(rng, sigs, vads, targets_l, dist_l)
            mic_signal = np.sum(sigs, axis=0)
            vad = np.concatenate(vads, axis=-1)
            targets = np.concatenate(targets_l, axis=-1)
            distances = np.concatenate(dist_l, axis=-1)
        else:
            mic_signal = sigs[0]
            vad, targets, distances = vads[0], targets_l[0], dist_l[0]

        # recorded noise at uniform SNR (RecordData.py:296-309)
        snr = float(rng.uniform(*self.SNR))
        npath = self.noise_paths[int(rng.integers(0,
                                                  len(self.noise_paths)))]
        nbase = npath.replace(f"_CH0.{self.ext}", f".{self.ext}")
        nlen, nfast = self._crop_probe(nbase, mic_ids)
        if nfast and nlen >= nsample:
            nstart = int(rng.integers(0, nlen - nsample + 1))
            noise = self._load_channels_window(nbase, mic_ids, nstart,
                                               nsample)
        else:
            noise = self._load_channels(nbase, mic_ids)
            if noise.shape[0] < nsample:
                noise = np.tile(noise, (nsample // noise.shape[0] + 1, 1))
            nstart = int(rng.integers(0, noise.shape[0] - nsample + 1))
            noise = noise[nstart: nstart + nsample]
        mic_signal = mic_signal + self.get_snr_coeff(
            mic_signal, noise, snr) * noise

        topo = self.pos_mics[mic_ids]
        return (mic_signal.astype(np.float32), targets, vad, topo,
                distances)

    def _apply_overlap(self, rng, sigs, vads, targets_l, dist_l):
        """The reference's overlap modes (RecordData.py:239-294):
        30% single source, else head-tail / middle-only / head-or-tail /
        full overlap, masks at 10 Hz (×1600 samples)."""
        if rng.random() < 0.3:
            sigs[1][:] = 0
            vads[1][:] = 0
            targets_l[1][:] = 0
            dist_l[1][:] = 0
            return

        def mask(spk, sl, fr):
            vads[spk][sl] = 0
            targets_l[spk][sl] = 0
            dist_l[spk][sl] = 0
            sigs[spk][fr] = 0

        mode = int(rng.choice([1, 2, 3, 4]))
        if mode == 1:      # head-tail
            for spk in range(2):
                n = int(rng.integers(0, 10))
                if n == 0:
                    continue
                if spk == 0:
                    mask(spk, slice(None, n), slice(None, n * 1600))
                else:
                    mask(spk, slice(-n, None), slice(-n * 1600, None))
        elif mode == 2:    # speaker 0 active only in the middle
            n = int(rng.integers(20, 35))
            half = int((40 - n) / 2)
            if half > 0:
                mask(0, slice(None, half), slice(None, half * 1600))
                mask(0, slice(-half, None), slice(-half * 1600, None))
        elif mode == 3:    # one-sided partial overlap
            n = int(rng.integers(0, 20))
            if n > 0:
                if rng.random() < 0.5:
                    mask(0, slice(None, n), slice(None, n * 1600))
                else:
                    mask(0, slice(-n, None), slice(-n * 1600, None))
        # mode 4: full overlap, no masking


def collate_realman(items):
    """Stack on-the-fly RealData items into the ipdnet2 task batch
    contract {'mic_sig', 'azi_deg', 'distance', 'vad', 'mic_pos'}.
    All items in a batch must share one mic subset (fixed-array mode)."""
    sig = np.stack([it[0] for it in items]).astype(np.float32)
    targets = np.stack([np.asarray(it[1]) for it in items]
                       ).astype(np.float32)
    vad = np.stack([np.asarray(it[2]) for it in items]).astype(np.float32)
    topo = np.stack([np.asarray(it[3]) for it in items]
                    ).astype(np.float32)
    dist = np.stack([np.asarray(it[4]) for it in items]).astype(np.float32)
    return {"mic_sig": sig, "azi_deg": targets, "distance": dist,
            "vad": vad, "mic_pos": topo}
