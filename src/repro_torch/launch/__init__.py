"""Launchers of the port. So far the serving launcher (`serve`); the train,
dry-run, mesh and roofline launchers wait for ROADMAP Queue 1's `launch/`
item."""
