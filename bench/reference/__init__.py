"""The plain reference of each deployment kind, and the yardstick's byte
counts. Plain PyTorch: imports nothing of ``repro_torch``, ``repro`` or
``jax``, and takes nothing the port made. Each module draws its kind's
data again from the seed (``datagen``) and counts every spec from it;
``control=True`` counts from every second word or row and doubles it -
the approximate answer, in place of the exact one the configuration
guarantees, that ``correct`` must refuse."""
