"""Scene-side model components: camera, voxel volumes, .vox loading and
the scene's sun constants."""
