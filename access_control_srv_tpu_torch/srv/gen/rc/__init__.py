"""Generated restorecommerce-wire stubs (see proto/build_rc.py);
the proto sources under proto/rc/ are reconstructions of the
public @restorecommerce/protos package."""
