"""Float models: MobileNetV2 + URSONet head, and the flax weight carry."""
