"""The plain reference: a Whitted ray tree, its camera and samples, a PNG
decoder and Adam, in plain PyTorch and NumPy.  It imports nothing of the
program and takes nothing the program made; the benchmark hands it the
same scene recipe, samples and parameters it hands the program."""
