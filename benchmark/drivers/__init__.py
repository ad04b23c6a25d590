"""One module a kind of traffic; a traffic mix names its driver."""
