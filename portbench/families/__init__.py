"""Model families. A configuration file's ``family`` names a package here
that holds the family's parameter layout (``layout``), its configuration
as the port takes it (``port``), its plain reference (``reference``) and
its counts of work (``work``)."""
