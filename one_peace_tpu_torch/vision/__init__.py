"""The vision transfer apps: detection (trunk, pyramid, proposers, RoIAlign,
cascade and mask heads, ``OnePeaceDetector``) and segmentation (the
ViT-Adapter backbone, the UperNet and Mask2Former heads, the two
segmenters)."""
