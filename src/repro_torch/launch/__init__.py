"""Launchers of the port: serving (`serve`) and training (`train`); the
dry-run, mesh and roofline launchers wait for ROADMAP Queue 1's `launch/`
item."""
