"""The examples of the port (twins of the repo's ``examples/*.py``),
each run as ``python -m orbitanalysis_tpu_torch.examples.<name>``:

- :mod:`~orbitanalysis_tpu_torch.examples.example_script`: track orbits,
  collate, decompose and plot (HDF5 files, so on the CPU: the card
  machine has no ``h5py``);
- :mod:`~orbitanalysis_tpu_torch.examples.onthefly_integrator`: the
  integrator with on-the-fly detection and checkpoints;
- :mod:`~orbitanalysis_tpu_torch.examples.distributed_simulation`:
  slab-resident distributed P3M over the ranks of a world.

Each runs on the card unless ``--cpu`` is given, and has a ``main``
function that takes the same arguments and returns its printed summary.
"""
