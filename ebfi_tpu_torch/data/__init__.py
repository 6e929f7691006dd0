"""The host fetch plane (port of ``ebfi_tpu/data``): schema H5 clips, read
and written by an HDF5 reader and writer of the port's own (no ``h5py``),
and clips in the ``ebfi_clip_npz/1`` container (``tools/h5_to_npz.py``
repacks H5 clips into it); windowing, blur synthesis, event encoding, augmentation,
and a loader with thread or spawned-process workers.  numpy, with the event
stacks and the blur synthesis on the C++ host plane
(:mod:`ebfi_tpu_torch.native`)."""
