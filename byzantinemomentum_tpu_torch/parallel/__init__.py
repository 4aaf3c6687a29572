"""Sequence parallelism (`byzantinemomentum_tpu/parallel/`): the dense
attention the transformer runs on one device. The ring and Ulysses forms
over a mesh's sequence axis, and the mesh itself, are not ported yet."""
