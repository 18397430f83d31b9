"""Model code of the port (``transformer.Model`` is the entry point).  The
package init imports nothing, so the kernels' plain versions can import
``models.attention`` without a cycle."""
