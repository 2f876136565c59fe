"""Weight conversion into the port's layouts: the JAX package's variables
and timm-layout ViT checkpoints."""
