"""Traffic mixes: `<name>.json` names its generator module of this package
and its parameters; generate.py makes the dataset."""
