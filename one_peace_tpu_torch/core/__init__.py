"""Configuration, registries and training metrics (copies of the JAX
package's, so the port imports none of it)."""
