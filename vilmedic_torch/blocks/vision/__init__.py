"""Vision towers: DenseNet, ResNet, ViT, DINOv2, and the VisualEncoder."""
