"""The trainers' data path: the filesystem dataset over annotator outputs,
its PIL-free transforms, the prefetching loaders and the training masks."""
