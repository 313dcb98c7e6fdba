"""Meshes (:mod:`.mesh`) and the dry run's sharded byte counts
(:mod:`.dryrun`)."""
