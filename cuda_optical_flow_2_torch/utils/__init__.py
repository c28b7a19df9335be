"""Scoring, scenes, frame and flow I/O, visualization (numpy copies of the JAX
package's modules, and the torch colorizer ``viz.flow_to_color_device``),
native frame ingestion (``native``), device timing (``profiling``) and the
per-stage A/B tool (``debug``)."""
