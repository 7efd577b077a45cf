"""One module a deployment kind (a config's ``kind``): builds the kind's
data into the port from the seed and turns a query spec into the plan the
port's apps make for it."""
