"""Dense decoder models: layers, GQA attention, the transformer."""
