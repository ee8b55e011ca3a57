"""The companion tools, each run as `python -m gnina_tpu_torch.tools.<name>`:
gninagrid, gninatyper, gninavis, tognina, fromgnina, the minimisation
server and its client."""
