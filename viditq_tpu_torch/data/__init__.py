"""Data loading (port of `viditq_tpu/data/`): the CSV dataset, the
transforms, video decoding, the native preprocessing library and the
resumable sampler with its batching."""
