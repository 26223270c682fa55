from knnsvc_torch.io.audio import load_audio, save_audio, resample, to_mono

__all__ = ["load_audio", "save_audio", "resample", "to_mono"]
