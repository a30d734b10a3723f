"""The trainers of the weights the port ships, run as modules:

    python -m alphadia_torch.scripts.train_default_classifier [--out DIR] [--device cpu]
    python -m alphadia_torch.scripts.train_property_models [--out DIR] [--device cpu]
"""
