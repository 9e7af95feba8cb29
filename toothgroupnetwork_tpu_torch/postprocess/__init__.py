"""Host postprocessing of the tgnet pipeline: clustering, fusion and the
boundary resampling (counterpart of toothgroupnetwork_tpu/postprocess)."""
