"""The detection demo: counterpart of the JAX package's demo/ (image,
folder, video and webcam inference, optional tracking), run as
``python -m ir_ads_tpu_torch.demo.demo``."""
