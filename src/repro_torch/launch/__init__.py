"""Launchers of the port: serving (`serve`), training (`train`), the device
meshes (`mesh`), the multi-pod dry run on a fake process group (`dryrun`),
its roofline terms (`roofline`) and report tables (`report`)."""
