"""A tiny in-memory dataset for the port's runner-level tests (0.2 s
windows, pads 600 / 97,020 / 560), and short `.mat` recordings for its
command-line tests."""
import numpy as np

T_EEG_PAD, T_AUDIO_PAD, N_RS_MAX = 600, 97_020, 560


class TinyDataset:
    """n_subjects × {slow, fast} recordings made from a seed.  EEG lengths
    sit in the middle of a window step and the audio has exactly the EEG's
    duration, so both sides count the same windows (17–25, or
    n_windows[i]) — except the recordings in one_step_short_audio, whose
    audio loses one step (control deviants), and those in fails, which
    raise on load."""

    def __init__(self, cfg, n_subjects=4, seed=0, n_windows=None,
                 one_step_short_audio=(), fails=()):
        self.cfg, self.seed = cfg, seed
        self.n_windows = dict(n_windows or {})
        self.short_audio, self.fails = set(one_step_short_audio), set(fails)
        self.index = [(f"bb{s:02d}_ut01.mat", f"bb{s:02d}", cond)
                      for s in range(1, n_subjects + 1)
                      for cond in ("slow", "fast")]

    def __len__(self):
        return len(self.index)

    def load(self, i):
        if i in self.fails:
            raise OSError("corrupt file")
        cfg = self.cfg
        fn, subj, cond = self.index[i]
        rng = np.random.default_rng(self.seed * 1000 + i)
        win, step = cfg.win_samples, cfg.step_samples
        n_win = int(rng.integers(17, 26))
        n_win = self.n_windows.get(i, n_win)
        n_e = win + (n_win - 1) * step + step // 2
        n_a = n_e * cfg.fs_audio // cfg.fs_eeg
        if i in self.short_audio:
            n_a -= step * cfg.fs_audio // cfg.fs_eeg
        t = np.arange(n_a) / cfg.fs_audio
        rate = 3.0 if cond == "slow" else 5.5
        am = 1.0 + 0.7 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 6))
        audio = am * rng.standard_normal(n_a)
        return dict(filename=fn, subject=subj, condition=cond,
                    eeg_raw=rng.standard_normal((65, n_e)).astype(np.float32),
                    audio=(audio / np.abs(audio).max()).astype(np.float32))


MAT_DURATIONS = (1.3, 1.8, 2.1, 1.5, 1.9, 1.4, 2.0, 2.2)


def write_mat_recordings(root, durations=MAT_DURATIONS, seed=0):
    """len(durations) / 2 subjects × {slow, fast} recordings of the given
    seconds in the reference's layout (root/slow, root/fast; keys `subeeg`
    transposed to samples × 65, stereo `y`, `Fs`), made from a seed; they fit
    the pads above at 1 s windows."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    durs = iter(durations)
    n_subjects = len(durations) // 2
    for cond in ("slow", "fast"):
        (root / cond).mkdir(parents=True)
        for s in range(1, n_subjects + 1):
            dur = next(durs)
            n_e, n_a = int(round(250 * dur)), int(round(44100 * dur))
            savemat(root / cond / f"bb{s:02d}_ut01.mat",
                    dict(subeeg=rng.standard_normal((65, n_e)).T,
                         y=rng.standard_normal((n_a, 2)), Fs=np.array([[44100]])))
    return root
