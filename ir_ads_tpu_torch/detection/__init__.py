"""The open-set detection stack (vCLR deformable-mask DINO): counterpart of
ir_ads_tpu/detection/.

Layout: public functions and modules take and return what the JAX package's
do, feature maps as NHWC (B, H, W, C) and tokens as (B, N, C); a convolution
permutes to NCHW inside (a channels-last view, no copy) and back.
Parameters carry the reference checkpoint's names (the left-hand names of
ir_ads_tpu/utils/torch_import.import_dino_state_dict).  The compute dtype is
the dense and convolution parameters' dtype (normalisations keep theirs in
f32 and compute as flax does, ``ops.layers``): an f32 tensor that meets a layer (a sine embedding, a
reference point) is cast to it, as a flax layer with ``dtype`` set casts its
input; reference points, proposals and boxes stay f32 throughout.
LayerNorm and GroupNorm use eps 1e-6 (flax's default, which the JAX modules
keep), BatchNorm 1e-5.
"""
