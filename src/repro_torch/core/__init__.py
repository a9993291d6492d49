"""The Pliant control plane: copies of the JAX package's ``core`` modules
(variants, monitor, controller, arbiter, tenant, runtime) and the serving
path of its explorer. They are framework-free Python; the port keeps its
own copies so that it imports nothing of the JAX package."""
