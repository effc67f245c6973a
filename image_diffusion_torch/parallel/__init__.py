"""More than one device: process groups, meshes, row layouts and FSDP."""
