"""Model towers of the port: StyleGAN2 generator, ResNet-50 regressor."""
