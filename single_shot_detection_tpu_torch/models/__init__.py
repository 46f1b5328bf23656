"""Model layer: MobileNetV2 backbone, feature taps, SSD detector (NCHW)."""
